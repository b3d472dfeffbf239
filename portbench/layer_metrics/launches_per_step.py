"""launches_per_step: kernels launched by the profiled blocks (``AFQMC``'s
``run_block``, kernel events of the trace) a step."""

RANGES = ()


def read(t):
    if not t.steps or not t.launches:
        return None
    return t.launches / t.steps
