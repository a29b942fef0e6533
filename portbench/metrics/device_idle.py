"""The device's idle share of the traced stretch (%): one less the union
of its kernels, copies and fills over the stretch's wall time."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return (1.0 - tr["busy_s"] / tr["window_s"]) * 100.0
