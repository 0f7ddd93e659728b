"""cuda_graphs.no_host_sync: a host read inside the block raises, on the
thread inside it only.

torch.cuda.set_sync_debug_mode is process-wide, so no_host_sync does not use
it: while one engine captures or replays a step, a host read on another
thread (another engine's request) must go through. The check is a torch
function mode, which is thread-local; it needs no card. The tests record
set_sync_debug_mode calls and hold them to none.
"""
import threading

import pytest
import torch

from umbrella_tpu_torch import cuda_graphs

READS = {
    "item": lambda t: t[0].item(),
    "tolist": lambda t: t.tolist(),
    "numpy": lambda t: t.numpy(),
    "cpu": lambda t: t.cpu(),
    "to_cpu": lambda t: t.to("cpu"),
    "to_cpu_device": lambda t: t.to(device=torch.device("cpu")),
    "bool": lambda t: bool(t[0]),
    "int": lambda t: int(t[0]),
    "float": lambda t: float(t[0]),
    "nonzero": lambda t: torch.nonzero(t),
    "nonzero_method": lambda t: t.nonzero(),
}


@pytest.fixture
def sets(monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", made.append)
    return made


@pytest.mark.parametrize("read", sorted(READS))
def test_host_reads_raise_inside_the_block(sets, read):
    t = torch.tensor([1.0, 0.0, 2.0])
    with cuda_graphs.no_host_sync():
        with pytest.raises(RuntimeError, match="host read inside"):
            READS[read](t)
        # what a step does is allowed: device ops and non-blocking copies
        (t * 2).sum()
        t.to("cpu", non_blocking=True)
        t.to(torch.float64)
    READS[read](t)
    assert sets == [] and cuda_graphs.host_reads_checked() == 0


@pytest.mark.parametrize("first_out", ["a", "b"])
def test_overlapping_threads_keep_the_mode_until_both_leave(sets, first_out):
    """a enters, b enters, one leaves, then the other: each is checked while
    it is inside (a read raises there) and not once it has left, whatever
    the other thread does; a third thread that never enters reads freely
    throughout; the process-wide mode is never set."""
    t = torch.tensor([3.0, 4.0])
    entered = {k: threading.Event() for k in "ab"}
    leave = {k: threading.Event() for k in "ab"}
    left = {k: threading.Event() for k in "ab"}
    seen = {}

    def try_read(key):
        try:
            seen[key] = t[0].item()
        except RuntimeError:
            seen[key] = "raised"

    def run(name):
        with cuda_graphs.no_host_sync():
            try_read(f"{name} inside")
            entered[name].set()
            assert leave[name].wait(10)
        try_read(f"{name} after")
        left[name].set()

    def outside(key):
        th = threading.Thread(target=try_read, args=(key,))
        th.start()
        th.join(10)

    threads = {k: threading.Thread(target=run, args=(k,)) for k in "ab"}
    threads["a"].start()
    assert entered["a"].wait(10)
    threads["b"].start()
    assert entered["b"].wait(10)
    outside("outside, both inside")
    last = "b" if first_out == "a" else "a"
    leave[first_out].set()
    assert left[first_out].wait(10)
    outside(f"outside, {last} inside")
    try_read("main")
    leave[last].set()
    for th in threads.values():
        th.join(10)
    assert seen == {"a inside": "raised", "b inside": "raised", "a after": 3.0, "b after": 3.0,
                    "outside, both inside": 3.0, f"outside, {last} inside": 3.0, "main": 3.0}
    assert sets == []


def test_nested_and_raising_blocks_restore_the_mode(sets):
    """A nested block keeps the check on when it leaves; a block left by an
    exception takes it off."""
    t = torch.tensor([1.0])
    with pytest.raises(ValueError):
        with cuda_graphs.no_host_sync():
            with cuda_graphs.no_host_sync():
                assert cuda_graphs.host_reads_checked() == 2
            assert cuda_graphs.host_reads_checked() == 1
            with pytest.raises(RuntimeError, match="host read inside"):
                t.item()
            raise ValueError("step failed")
    assert cuda_graphs.host_reads_checked() == 0 and t.item() == 1.0 and sets == []
