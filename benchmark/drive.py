"""The two closed loops that drive the port, and their set-up.

`ServeLoop`: `clients` clients send through `serving/scheduler.make_scheduler`
in front of a `serving/batched_engine.ContinuousBatcher` on its pipelined
loop; each sends its next request when the last one completes, and reads
every streamed frame as it arrives. `ChatLoop`: one client streams its
requests one after the other through the engine's `generate_stream`.

Both run the loop in threads of their own, so that the main thread keeps the
window's clock; both record what a client sees (window.Record) and read the
engine's counters (`counters()`: the values, and `at`, the host time at
which they held).
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np

from benchmark.window import Record


def _tokens_of(perf) -> Optional[int]:
    """Tokens delivered so far, from a streamed frame's perf field: the
    result dict of the last frame, or the "Output Tokens N | ..." log."""
    if isinstance(perf, dict):
        return len(perf.get("generated_tokens") or [])
    if isinstance(perf, str) and perf.startswith("Output Tokens "):
        return int(perf.split()[2])
    return None


def warm_prompts(lengths, seed: int, vocab: int):
    rng = np.random.default_rng([seed, 7])
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lengths]


class ServeLoop:
    def __init__(self, engine, traffic, mix: dict):
        self.eng, self.traffic, self.mix = engine, traffic, mix
        self.records: List[Record] = []
        self._lock = threading.Lock()
        self._next = 0
        self._stop = threading.Event()
        self.sched = self.batcher = None

    def warm(self, seed: int, vocab: int) -> None:
        """Every prefill bucket, a prompt of several chunks and both segment
        graphs (all slots greedy; greedy and sampled slots together), through
        the engine's serial run()."""
        B = self.eng.batch_size
        lens = [20, 50, 100, 200, 400, 1100] * (B // 6 + 1)
        prompts = warm_prompts(lens[:B], seed, vocab)
        s = self.mix["sampling"]
        for mixed in (False, True):
            self.eng.run([dict(input_ids=p, max_new_tokens=16,
                               temperature=s["temperature"] if mixed and i % 2 else 0.0,
                               topp=s["topp"]) for i, p in enumerate(prompts)])

    def start(self) -> None:
        """The serving loop, then the clients' first requests spread evenly over
        the mix's ramp (clients arrive over time, so the slots do not start
        and end in step)."""
        from umbrella_tpu_torch.serving.batched_engine import ContinuousBatcher
        from umbrella_tpu_torch.serving.scheduler import make_scheduler

        self.batcher = ContinuousBatcher(self.eng, pipeline=True)
        self.batcher.start()
        self.sched = make_scheduler(batcher=self.batcher)
        self.sched.start()
        n, ramp = int(self.mix["clients"]), float(self.mix["ramp_seconds"])
        t0 = time.time()

        def arrive():
            for i in range(n):
                time.sleep(max(0.0, t0 + i * ramp / n - time.time()))
                self._send()

        self._starter = threading.Thread(target=arrive, daemon=True)
        self._starter.start()

    def _send(self) -> None:
        with self._lock:
            if self._stop.is_set():
                return
            k, self._next = self._next, self._next + 1
            req = self.traffic.request(k)
            rec = Record(index=k, prompt_len=len(req.prompt), max_new=req.max_new,
                         greedy=req.greedy, sent=time.time())
            self.records.append(rec)

        def frame(_text, perf, rec=rec):
            n = _tokens_of(perf)
            if n is not None:
                rec.arrive(time.time(), n)

        fut = self.sched.submit(priority=1, stream_cb=frame, input_ids=req.prompt,
                                max_new_tokens=req.max_new, temperature=req.temperature,
                                topp=req.topp, repetition_penalty=req.repetition_penalty)
        fut.add_done_callback(lambda f, rec=rec: self._done(rec, f))

    def _done(self, rec: Record, fut) -> None:
        rec.done = time.time()
        err = fut.exception()
        if err is not None:
            rec.failed = not self._stop.is_set()
            return
        rec.tokens = list(fut.result().get("generated_tokens") or [])
        self._send()

    def counters(self) -> dict:
        m = self.sched.snapshot_metrics()
        return dict(steps=self.eng.steps_dispatched, queue_s=m["queue_seconds"],
                    sched_requests=m["requests"], at=time.time())

    def stop(self, wait_s: float) -> None:
        """No new requests; wait up to wait_s for the requests already
        decoding, then shut the loop down (queued requests are dropped)."""
        self._stop.set()
        self._starter.join()
        end = time.time() + wait_s
        while time.time() < end:
            with self._lock:
                busy = [r for r in self.records if r.first is not None and r.done is None]
            if not busy:
                break
            time.sleep(0.05)
        self.sched.shutdown(wait=False)
        self.batcher.shutdown()


class ChatLoop:
    def __init__(self, engine, traffic, mix: dict):
        self.eng, self.traffic, self.mix = engine, traffic, mix
        self.records: List[Record] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        # (time, the engine's live steps) at the loop's start and at each
        # frame: a stream frame comes every 32 committed tokens, while
        # decode_stats moves at every block of replays inside it, so steps
        # are read where the tokens are
        self._steps = []

    def warm(self, seed: int, vocab: int) -> None:
        """Every prefill bucket and a prompt of several chunks, greedy; then
        the sampled step with its repetition penalty: one token each."""
        s = self.mix["sampling"]
        for p in warm_prompts([20, 50, 100, 200, 400, 1100], seed, vocab):
            self.eng.generate(input_ids=p, max_new_tokens=1, temperature=0.0, topp=s["topp"],
                              repetition_penalty=1.0)
        self.eng.generate(input_ids=p, max_new_tokens=1, temperature=s["temperature"],
                          topp=s["topp"], repetition_penalty=s["repetition_penalty"])

    def _live_steps(self) -> int:
        st = self.eng.decode_stats
        return st["replays"] - st["noop_replays"]

    def start(self) -> None:
        self._steps = [(time.time(), self._live_steps())]
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        from umbrella_tpu_torch.utils import device_scope

        try:
            with device_scope(self.eng.device):
                k = 0
                while not self._stop.is_set():
                    self._one(k)
                    k += 1
        except Exception as e:  # raised again in the harness's thread by stop()
            self.error = e

    def _one(self, k: int) -> None:
        req = self.traffic.request(k)
        rec = Record(index=k, prompt_len=len(req.prompt), max_new=req.max_new,
                     greedy=req.greedy, sent=time.time())
        self.records.append(rec)
        text, complete = "", True
        stream = self.eng.generate_stream(
            input_ids=req.prompt, max_new_tokens=req.max_new, temperature=req.temperature,
            topp=req.topp, repetition_penalty=req.repetition_penalty)
        for text, _perf in stream:
            now = time.time()
            rec.arrive(now, len(text.split()))
            self._steps.append((now, self._live_steps()))
            if self._stop.is_set() and not req.greedy:
                complete = False  # a sampled request left at the window's close
                stream.close()
                break
        if complete:
            rec.done = time.time()
            rec.tokens = [int(w) for w in text.split()]

    def counters(self) -> dict:
        """The live steps at the last frame so far, `at` that frame (or at
        the loop's start, before its first frame)."""
        at, steps = self._steps[-1]
        return dict(steps=steps, at=at)

    def stop(self, wait_s: float) -> None:
        self._stop.set()
        self._thread.join(timeout=wait_s)
        if self._thread.is_alive():
            raise RuntimeError(f"the chat client did not finish within {wait_s} s")
        if self.error is not None:
            raise self.error


LOOPS = {"scheduler": ServeLoop, "stream": ChatLoop}


def make_engine(built, engine_keys: dict, growmap_path: str):
    """The engine of a mix's keys over the built target and draft (EOS off)."""
    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

    keys = {k: v for k, v in engine_keys.items() if k != "growmap"}
    eng = AutoEngine.from_config(device=built.target.device, model=built.target,
                                 draft_model=built.draft, growmap_path=growmap_path,
                                 eos_token_ids=[-1], **keys)
    eng.initialize()
    return eng
