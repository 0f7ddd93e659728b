"""Socket API server, the counterpart of `umbrella_tpu/api/server.py`.

A thread per connection reads requests (api_utils framing). Three routes:

- one engine (the default): a single worker thread runs the requests one at a
  time through `engine.generate(**request)` (`generate_stream` for
  `"stream": true`); a request whose generate() raises gets an error result
  and the worker goes on;
- a ContinuousBatcher (`"engine": "batched_static"` in the config, or an
  injected `batcher`): concurrent requests decode together in the batched
  engine's slots and each answer returns when its slot finishes;
- a Scheduler (a `"scheduler": {...}` config key, even `{}`, or an injected
  `scheduler`): a priority queue in front of either backend
  (serving/scheduler.make_scheduler), with a per-request `"priority"` (lower
  is sooner) and `{"get_metrics": true}` for its metrics, with the process's
  span totals under `"spans"` (profiling.totals(): behind a batcher the
  scheduler's queue is near empty, and `serve.queue` shows the wait).

`"stream": true` sends partial frames {"partial": true, "generated_text":
text so far, "perf": str} before the final result; a client-chosen `req_id`
is echoed in each frame and in the result. `{"terminate": true}` closes the
connection. Every message is JSON: numpy and torch values in a result are
sent as numbers and lists, callables are left out.

The engine runs on the GPU unless the server is given `device="cpu"`.
"""
from __future__ import annotations

import socket
import threading
from queue import Queue

from .. import profiling
from ..speculation.auto_engine import AutoEngine
from ..utils import TextColors, device_scope, setup_logger
from .api_utils import receive_data, send_data

logger = setup_logger()

_ERROR_RESULT = {"generated_text": "", "generated_tokens": [], "avg_accept_tokens": 0,
                 "time_per_output_token": 0}


def jsonable(value):
    """`value` with numpy scalars and arrays and torch tensors turned into
    Python numbers and lists, and dict entries that hold a callable dropped:
    what send_data can encode."""
    if isinstance(value, dict):
        return {k: jsonable(v) for k, v in value.items() if not callable(v)}
    if isinstance(value, (list, tuple)):
        return [jsonable(v) for v in value]
    if hasattr(value, "tolist"):  # numpy scalars and arrays, torch tensors
        return value.tolist()
    return value


class APIServer:
    def __init__(self, config: dict, device="cuda", port: int = 65432, max_client: int = 4,
                 host: str = "127.0.0.1", engine=None, batcher=None, scheduler=None):
        self.port = port
        self.max_client = max_client
        self.host = host
        self.device = device
        self.config = config
        self.engine = engine  # injectable, as the two below
        self.batcher = batcher  # a ContinuousBatcher: concurrent serving
        self.scheduler = scheduler  # a Scheduler: the priority queue
        self.server_socket = None
        self.message_queue = Queue()
        self.queue_lock = threading.Lock()
        self._conns, self._conns_lock = set(), threading.Lock()  # open connections

    def handle_client(self, conn, addr):
        logger.info(TextColors.colorize(f"Connection from {addr}", "cyan"))
        send_lock = threading.Lock()  # batched results and frames may interleave
        with self._conns_lock:
            self._conns.add(conn)
        try:
            send_data(conn, {"status": "connected", "message": "Welcome to the server!"})
            while True:
                try:
                    received = receive_data(conn)
                    logger.info(TextColors.colorize(f"Received dictionary from {addr}", "cyan"))
                    if received.get("terminate", False):
                        break
                    stream = bool(received.pop("stream", False))
                    req_id = received.pop("req_id", None)
                    stream_cb = (self._make_stream_cb(conn, addr, send_lock, req_id)
                                 if stream else None)
                    if self.scheduler is not None:
                        if received.get("get_metrics", False):
                            with send_lock:
                                send_data(conn, jsonable(dict(self.scheduler.snapshot_metrics(),
                                                              spans=profiling.totals(),
                                                              processed=True)))
                            continue
                        priority = int(received.pop("priority", 10))
                        fut = self.scheduler.submit(priority=priority, stream_cb=stream_cb,
                                                    **received)
                        fut.add_done_callback(
                            lambda f, c=conn, a=addr, lk=send_lock, r=req_id:
                            self._send_result(c, a, lk, f, r))
                    elif self.batcher is not None:
                        if stream_cb is not None:
                            received["stream_cb"] = stream_cb
                        fut = self.batcher.submit(**received)
                        fut.add_done_callback(
                            lambda f, c=conn, a=addr, lk=send_lock, r=req_id:
                            self._send_result(c, a, lk, f, r))
                    else:
                        self.message_queue.put((addr, conn, received, stream_cb, req_id,
                                                send_lock))
                except Exception as e:
                    logger.error(TextColors.colorize(f"Error handling data from {addr}: {e}",
                                                     "red"))
                    break
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            conn.close()
            logger.info(TextColors.colorize(f"Connection with {addr} closed", "cyan"))

    def _make_stream_cb(self, conn, addr, send_lock, req_id):
        def cb(text, perf):
            frame = {"partial": True, "generated_text": text,
                     "perf": perf if isinstance(perf, str) else None}
            if req_id is not None:
                frame["req_id"] = req_id
            try:
                with send_lock:
                    send_data(conn, frame)
            except Exception as e:
                logger.error(TextColors.colorize(f"Error streaming to {addr}: {e}", "red"))
        return cb

    @staticmethod
    def _processed(result=None, error=None, req_id=None) -> dict:
        if error is None:
            out = {**result, "processed": True, "response": "Processed successfully"}
        else:
            out = {"processed": False, "error": f"{type(error).__name__}: {error}",
                   **_ERROR_RESULT}
        if req_id is not None:
            out["req_id"] = req_id
        return jsonable(out)

    def _send(self, conn, addr, send_lock, message) -> None:
        try:
            with send_lock:
                send_data(conn, message)
        except Exception as e:
            logger.error(TextColors.colorize(f"Error sending data to {addr}: {e}", "red"))

    def _send_result(self, conn, addr, send_lock, fut, req_id=None):
        try:
            message = self._processed(fut.result(), req_id=req_id)
        except Exception as e:  # e.g. the scheduler's DeadlineExpired
            message = self._processed(error=e, req_id=req_id)
        self._send(conn, addr, send_lock, message)

    def process_queue(self):
        """The single-engine worker: one request at a time, on the engine's device."""
        with device_scope(getattr(self.engine, "device", None)):
            while True:
                item = self.message_queue.get()
                if item[2] is None:  # the shutdown sentinel
                    return
                addr, conn, message, stream_cb, req_id, send_lock = item
                with self.queue_lock:
                    # a failing generate (bad arguments, say) fails that client
                    # only: the worker must survive, or every later request
                    # would wait in the queue for ever
                    try:
                        if stream_cb is not None:
                            partial = perf = None
                            for partial, perf in self.engine.generate_stream(**message):
                                stream_cb(partial, perf)
                            output = perf if isinstance(perf, dict) else {
                                "generated_text": partial or "", "perf": perf}
                        else:
                            output = self.engine.generate(**message)
                        processed = self._processed(output, req_id=req_id)
                    except Exception as e:
                        logger.exception("generate failed for %s", addr)
                        processed = self._processed(error=e, req_id=req_id)
                    self._send(conn, addr, send_lock, processed)

    def start(self):
        """Build the engine from the config unless one was given (the
        `scheduler` key left out of the engine's config and consumed here),
        open the listening socket (`port=0` picks a free port, read back into
        `self.port`) and start the worker threads. Does not block."""
        sched_cfg = self.config.get("scheduler")
        if self.engine is None and self.batcher is None and self.scheduler is None:
            config = {k: v for k, v in self.config.items() if k != "scheduler"}
            batched = config.get("engine") == "batched_static"
            engine = AutoEngine.from_config(self.device, **config)
            engine.initialize()
            if batched:
                from ..serving.batched_engine import ContinuousBatcher

                self.batcher = ContinuousBatcher(engine)
            else:
                self.engine = engine
        if sched_cfg is not None and self.scheduler is None:
            from ..serving.scheduler import make_scheduler

            workers = sched_cfg.get("workers") if isinstance(sched_cfg, dict) else None
            self.scheduler = make_scheduler(engine=self.engine, batcher=self.batcher,
                                            workers=workers)
            self.engine = None  # requests go through the scheduler only
        if self.batcher is not None and getattr(self.batcher, "_thread", None) is None:
            self.batcher.start()
        if self.scheduler is not None and not self.scheduler._workers:
            self.scheduler.start()
        self.server_socket = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.server_socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.server_socket.bind((self.host, self.port))
        if self.port == 0:
            self.port = self.server_socket.getsockname()[1]
        self.server_socket.listen(self.max_client)
        logger.info(TextColors.colorize("umbrella_tpu_torch LLM server started", "cyan"))
        if self.batcher is None and self.scheduler is None:
            threading.Thread(target=self.process_queue, daemon=True).start()
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while True:
            try:
                conn, addr = self.server_socket.accept()
            except OSError:
                return  # socket closed
            threading.Thread(target=self.handle_client, args=(conn, addr), daemon=True).start()

    def run(self):
        """Blocking entry point."""
        self.start()
        self._accept_thread.join()

    def shutdown(self):
        """Stop the workers, the listener and every open connection: each
        thread the server started ends, and with them the last references to
        the engine (closing a socket alone does not wake a thread blocked in
        its accept() or recv())."""
        if self.scheduler is not None:
            self.scheduler.shutdown(wait=False)
        if self.batcher is not None:
            self.batcher.shutdown()
        self.message_queue.put((None, None, None))
        with self._conns_lock:
            socks = [s for s in (self.server_socket, *self._conns) if s is not None]
        for sock in socks:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # not connected, or closed already
            sock.close()
