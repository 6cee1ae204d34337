"""The CUDA propose kernel (kubetpu_torch/ops/csrc/propose.cu) against its
plain PyTorch version, bitwise.  The card test is marked ``cuda`` and
skips without a card; this file imports neither jax nor the JAX package,
so it also runs on a GPU machine that has only the port:

    python -m pytest tests/test_torch_propose_cuda.py -q

The CPU test checks the rows-by-index contract of the plain version
itself: reading window rows of a whole-batch bundle equals proposing on
a bundle made of just those rows."""
import pytest
import torch

from kubetpu_torch.harness import propose_worlds as PW
from kubetpu_torch.harness.propose_worlds import GENERIC_SCORES
from kubetpu_torch.models.programs import ProgramConfig
from kubetpu_torch.ops import propose as PK


@pytest.mark.parametrize("seed,B,N,bias,scores", [
    (30, 21, 133, False, None), (31, 16, 90, True, GENERIC_SCORES)])
def test_plain_rows_by_index_equal_gathered_bundle(seed, B, N, bias, scores):
    rows = PW.window_rows(seed, B, max(B // 2, 1) + 2, sentinels=2,
                          ordered=False)
    bundle, rows, wlive, req, nz, pu = PW.propose_args(
        PW.world(seed, B, N, bias, scores=scores), rows)
    rsafe = rows.clamp(0, B - 1)
    got = PK.propose_plain(bundle, rows, wlive, req, nz, pu)
    sub = dict(bundle, planes=bundle["planes"][:, rsafe])
    for k in ("mask", "ipa_any", "skip", "breq", "bnz", "bports"):
        sub[k] = bundle[k][rsafe]
    want = PK.propose_plain(sub, torch.arange(len(rows)), wlive, req, nz, pu)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not bool(got[1][rows >= B].any())
    assert bool((got[0][rows >= B] == N).all())


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU or "
                    "interpret mode (run on the GPU machine)")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda_card):
    """On the card: the CUDA kernel equals the plain version bitwise on
    each instantiation and branch: the default-family specialisation and
    the generic layout walk, 16 zones (shared-memory zone sums), N above
    the shared-memory staging threshold, ragged N (129, 333: bulk copies
    over the aligned interior, scalar ends), window rows out of order
    with sentinels, and division operands outside the fast division's
    range (recomputed with __fdiv_rn).  chip_smoke.py runs the same
    worlds at full width."""
    cases = [(10, 37, 200, False, 8, None, False),
             (11, 130, 333, True, 8, None, False),
             (13, 1, 129, True, 8, None, False),
             (14, 20, 300, True, 16, None, False),
             (15, 9, 17000, True, 16, None, False),
             (16, 40, 333, True, 8, GENERIC_SCORES, False),
             (17, 12, 17000, True, 16, GENERIC_SCORES, False),
             (18, 50, 400, True, 8, None, True),
             (19, 40, 333, False, 8, GENERIC_SCORES, True)]
    for seed, B, N, bias, Z, scores, extreme in cases:
        w = PW.world(seed, B, N, bias, Z, scores, extreme=extreme)
        assert w["layout"].default_family == (scores is None)
        window = PW.window_rows(seed, B, max(B // 2, 1) + 2, sentinels=2,
                                ordered=False)
        for rows in (None, window):
            args = PW.propose_args(w, rows, "cuda")
            k = PK.propose_cuda(*args)
            p = PK.propose_plain(*args)
            for a, b in zip(k, p):
                assert torch.equal(a, b), (seed, B, N, rows is None)
    assert PK.check_fast_div(1 << 24, seed=3) == 0
    staged_max = PK.staged_max_n(PK.layout_for(ProgramConfig(), True),
                                 5, 8, 16)
    assert 333 < staged_max < 17000
