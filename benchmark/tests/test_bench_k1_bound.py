"""The frozen count of K1's bytes and operations, against a hand count."""

from typing import NamedTuple, Tuple

import torch

from kbench import k1_bound


class Layout(NamedTuple):
    scores: Tuple
    planes: Tuple
    use_fit: bool
    use_ports: bool


def _bundle(N=8):
    planes = torch.zeros((1, 1, N), dtype=torch.float32)
    return dict(
        planes=planes, mask=torch.ones((1, N), dtype=torch.bool),
        ipa_any=torch.zeros(1, dtype=torch.bool),
        skip=torch.zeros(1, dtype=torch.bool),
        breq=torch.tensor([[100.0, 100.0, 0.0, 1.0]]),
        bnz=torch.tensor([[100.0, 100.0]]),
        bports=torch.zeros((1, 1)),
        layout=Layout(scores=(("NodeResourcesLeastAllocated", 1.0),),
                      planes=("gumbel",), use_fit=True, use_ports=False),
        allocT=torch.full((4, N), 1000.0),
        zid=torch.zeros(N, dtype=torch.int32), n_zones=1)


def test_hand_count_one_row_eight_nodes():
    N, R, P = 8, 4, 1
    b = _bundle(N)
    rows = torch.zeros(1, dtype=torch.int64)
    live = torch.ones(1, dtype=torch.bool)
    nbytes, ops = k1_bound.counts(b, rows, live, torch.zeros((N, R)),
                                  torch.zeros((N, 2)), torch.zeros((N, P)))
    # identical nodes: every node ties, so the gumbel plane is read at all
    # 8: one 32-byte sector if the row starts on a boundary, else two
    first = (b["planes"].data_ptr() // 4) % 8
    plane = 32 * (1 if first == 0 else 2)
    row = N + R * 4 + 2 * 4 + P * 4 + 1 + 1
    nodes = N * (R * 4 + 4 + R * 4 + 2 * 4 + P * 4)
    io = 1 * (8 + 1) + 1 * (4 + 4 + 1)
    assert nbytes == plane + row + nodes + io
    assert ops == N * (2 * R + 2 * P) + N * 40


def test_infeasible_nodes_read_no_plane_and_bound_is_the_larger():
    N = 8
    b = _bundle(N)
    b["mask"][0, 4:] = False
    rows = torch.zeros(1, dtype=torch.int64)
    live = torch.ones(1, dtype=torch.bool)
    args = (b, rows, live, torch.zeros((N, 4)), torch.zeros((N, 2)),
            torch.zeros((N, 1)))
    nbytes, ops = k1_bound.counts(*args)
    assert ops == 4 * 10 + 4 * 40
    want = max(nbytes / k1_bound.HBM_BYTES_PER_S,
               ops / k1_bound.F32_OPS_PER_S)
    assert k1_bound.bound_s(*args) == want
