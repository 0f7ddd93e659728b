"""w4a16_roofline (device trace): the least time of the W4A16 products that
the forwards needed a second, from the window's start to the traced span's
close (roofline.window_work), over the device time a second of the kernels
that run them in the span."""
from benchmark.roofline import window_work

KERNELS = ("w4a16_kernel", "w4a16_sum_partials")


def read(run):
    if run.trace is None:
        return None
    busy = sum(t for n, t in run.trace["by_name"].items() if any(k in n for k in KERNELS))
    need = window_work(run)["w4a16_s"]
    if busy <= 0 or need <= 0:
        return None
    return 100.0 * (need / run.seconds) / (busy / run.trace["window_s"])
