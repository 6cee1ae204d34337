"""The propose kernel's share of its roofline over the traced stretch: the
least time its launches could take (kbench/k1_bound.py, from each launch's
inputs) over the time its kernels took on the card (device trace), in %."""


def read(run):
    tr = run.trace
    if tr is None or not run.k1_bound_s:
        return None
    t = tr.kernel_s("propose_kernel")
    return 100.0 * sum(run.k1_bound_s) / t if t > 0 else None
