"""The port's request API (umbrella_tpu_torch/api, templates, app) against the
JAX package's on the CPU.

The wire format is byte-identical, so a client of either package talks to a
server of the other; a port server over a tiny StaticEngine answers with the
tokens of a JAX server over the same weights (fp32, greedy); the worker
survives a failing generate(); a `"scheduler": {}` config builds the
scheduler; every engine's result goes through send_data; the templates and
the gradio app's history prompt equal JAX's.
"""
import gc
import importlib.util
import json
import pathlib
import socket
import sys
import threading
import weakref

import numpy as np
import pytest
import torch

from test_static_engine import MAX_LEN
from test_torch_stream import WordTokenizer, engines, port_engine, runtimes
from umbrella_tpu import templates as jax_templates
from umbrella_tpu.api import api_utils as jax_api_utils
from umbrella_tpu.api.client import APIClient as JaxClient
from umbrella_tpu.api.server import APIServer as JaxServer
from umbrella_tpu_torch import templates
from umbrella_tpu_torch.api import api_utils
from umbrella_tpu_torch.api.client import APIClient
from umbrella_tpu_torch.api.server import APIServer, jsonable
from umbrella_tpu_torch.app import api as api_app
from umbrella_tpu_torch.app import chatbot, gradio_chat
from umbrella_tpu_torch.sequoia import growmap_from_spec
from umbrella_tpu_torch.serving.batched_engine import ContinuousBatcher
from umbrella_tpu_torch.serving.scheduler import BatcherBackend, Scheduler
from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

torch.set_num_threads(1)  # several workers share the cores

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROMPT = [1, 5, 9]


def _wire(mod, payload):
    """The bytes mod.send_data puts on a socket for payload."""
    a, b = socket.socketpair()
    with a, b:
        mod.send_data(a, payload)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while chunk := b.recv(65536):
            out += chunk
    return out


PAYLOADS = [
    {"status": "connected", "message": "Welcome to the server!"},
    {"input_ids": [1, 5, 9], "max_new_tokens": 8, "stream": True, "req_id": "r-7",
     "priority": 1, "temperature": 0.6, "topp": 0.9},
    {"generated_text": "déjà vu — 语言 ✓", "generated_tokens": list(range(300)),
     "avg_accept_tokens": 2.6666666666666665, "time_per_output_token": 1e-3, "processed": True},
    {"by_priority": {"1": {"requests": 2, "queue_seconds": 0.25}}, "nested": [[], {}, None]},
    {"context": "x" * 70000},
]


@pytest.mark.parametrize("payload", PAYLOADS, ids=range(len(PAYLOADS)))
def test_send_data_bytes_equal_jax(payload):
    """send_data writes JAX's bytes (a 4-byte big-endian length, then the
    JSON), and each package's receive_data reads the other's."""
    wire = _wire(api_utils, payload)
    assert wire == _wire(jax_api_utils, payload)
    assert int.from_bytes(wire[:4], "big") == len(wire) - 4
    for writer, reader in ((api_utils, jax_api_utils), (jax_api_utils, api_utils)):
        a, b = socket.socketpair()
        with a, b:
            writer.send_data(a, payload)
            assert reader.receive_data(b) == payload


class StubEngine:
    """A single-request engine for the server tests: echoes its prompt."""

    def __init__(self):
        self.calls = 0

    def generate(self, **req):
        self.calls += 1
        if req.get("boom"):
            raise RuntimeError("injected generate failure")
        ids = list(req.get("input_ids", [7]))
        return dict(req, generated_text=" ".join(map(str, ids)), generated_tokens=ids,
                    avg_accept_tokens=1.0, time_per_output_token=1.0)

    def generate_stream(self, **req):
        out = self.generate(**req)
        words = out["generated_text"].split()
        for i in range(1, len(words)):
            yield " ".join(words[:i]) + " ", f"Output Tokens {i}"
        yield out["generated_text"], "done"


def _serve(server_cls, client_cls, **server_kw):
    """Start a server of one package on port 0; return it and a connected
    client of the other (or the same) package."""
    server = server_cls(config={}, port=0, **server_kw)
    server.start()
    client = client_cls(port=server.port, retry_seconds=0.2)
    assert client.run() == {"status": "connected", "message": "Welcome to the server!"}
    return server, client


def _exchange(client):
    out = client.get_output(input_ids=[4, 2, 6], max_new_tokens=3, req_id=11)
    frames = list(client.stream_output(input_ids=[1, 2, 3], req_id="s"))
    return out, frames


@pytest.mark.parametrize("pair", ["port client, JAX server", "JAX client, port server"])
def test_cross_package_client_and_server(pair):
    """A port client against a JAX server and a JAX client against a port
    server, over stub engines: the same answers and stream frames (req_id
    echoed in each) as a JAX client gets from a JAX server."""
    server_cls, client_cls = ((JaxServer, APIClient) if pair.startswith("port")
                              else (APIServer, JaxClient))
    results = []
    for s_cls, c_cls in ((server_cls, client_cls), (JaxServer, JaxClient)):
        server, client = _serve(s_cls, c_cls, engine=StubEngine())
        try:
            results.append(_exchange(client))
            client.close()
        finally:
            server.shutdown()
    assert results[0] == results[1]
    out, frames = results[0]
    assert out["processed"] is True and out["req_id"] == 11
    assert out["generated_tokens"] == [4, 2, 6]
    assert [f["generated_text"] for f in frames] == ["1 ", "1 2 ", "1 2 3", "1 2 3"]
    assert all(f["req_id"] == "s" for f in frames) and frames[-1]["processed"] is True


def test_server_round_trip_equals_jax_server():
    """A port server over a tiny StaticEngine (device "cpu") and a JAX server
    over the same weights: each client request (greedy; input ids and a
    text prompt) gets the same tokens and text; a streamed request's frames
    are JAX's."""
    jeng, eng = engines("static", tokenizer=WordTokenizer(), stop_distance=8)
    answers = []
    for server_cls, e in ((JaxServer, jeng), (APIServer, eng)):
        server, client = _serve(server_cls, APIClient, engine=e)
        try:
            got = [client.get_output(input_ids=PROMPT, max_new_tokens=12),
                   client.get_output(context="hello world", max_new_tokens=20)]
            frames = [f["generated_text"] for f in
                      client.stream_output(input_ids=PROMPT, max_new_tokens=40)]
            client.close()
        finally:
            server.shutdown()
        answers.append(([(o["generated_tokens"], o["generated_text"], o["processed"])
                         for o in got], frames))
    assert answers[1] == answers[0]
    (tokens, _, processed), _ = answers[1][0]
    assert len(tokens) >= 12 and processed is True and len(answers[1][1]) >= 2


def test_worker_survives_a_failing_generate():
    """A request whose generate() raises fails that client with an error
    result; the single worker serves the next request."""
    eng = StubEngine()
    server, client = _serve(APIServer, APIClient, engine=eng)
    try:
        bad = client.get_output(boom=True, req_id=3)
        assert bad["processed"] is False and "injected generate failure" in bad["error"]
        assert bad["req_id"] == 3 and bad["generated_tokens"] == []
        good = client.get_output(input_ids=[1, 2, 3])
        assert good["processed"] is True and good["generated_tokens"] == [1, 2, 3]
        assert eng.calls == 2
        client.close()
    finally:
        server.shutdown()


@pytest.mark.parametrize("route", ["engine", "scheduler", "batcher"])
def test_shutdown_ends_every_thread_and_frees_the_engine(route):
    """After shutdown() every thread the server started has ended (the
    listener blocked in accept(), a client connection left open, the
    workers), so nothing holds the engine: it is freed with the server."""
    before = set(threading.enumerate())
    if route == "batcher":
        eng = AutoEngine.from_config(device="cpu", **_config("batched"))
        eng.initialize()
        kw = dict(batcher=ContinuousBatcher(eng))
    else:
        eng = StubEngine()
        kw = dict(engine=eng) if route == "engine" else dict(scheduler=Scheduler([eng]))
    ref = weakref.ref(eng)
    server, client = _serve(APIServer, APIClient, **kw)
    assert client.get_output(input_ids=PROMPT, max_new_tokens=4)["processed"] is True
    server.shutdown()  # the client's connection is still open
    for t in set(threading.enumerate()) - before:
        t.join(timeout=10)
        assert not t.is_alive(), t.name
    client.client_socket.close()
    del server, kw, eng
    gc.collect()
    assert ref() is None


def _config(kind, **kw):
    (_, _), (pt, pd) = runtimes()
    cfg = dict(model=pt, draft_model=pd, max_length=MAX_LEN, safe_buffer=32,
               eos_token_ids=[-1], dtype=torch.float32, tokenizer=WordTokenizer(),
               growmap=growmap_from_spec(3, 4), **kw)
    if kind == "batched":
        cfg.update(engine="batched_static", batch_size=2, segment_steps=2)
    else:
        cfg.update(engine="static")
    return cfg


@pytest.mark.parametrize("kind", ["static", "batched"])
def test_empty_scheduler_key_builds_a_scheduler(kind):
    """`"scheduler": {}` in a config dict (the shipped serve config's key):
    start() builds the engine on device "cpu" through AutoEngine with the
    key left out, then make_scheduler around it (one worker on the static
    engine, B + 2 BatcherBackend workers on the batched one); priorities
    route, the batcher reports admissions, get_metrics answers."""
    server = APIServer(config=_config(kind, scheduler={}, template="meta-llama3"), device="cpu",
                       port=0)
    server.start()
    try:
        assert isinstance(server.scheduler, Scheduler) and server.engine is None
        workers = server.scheduler.engines
        if kind == "batched":
            assert len(workers) == 4 and isinstance(workers[0], BatcherBackend)
            assert server.batcher.engine.device == torch.device("cpu")
        else:
            assert len(workers) == 1 and workers[0].device == torch.device("cpu")
        client = APIClient(port=server.port, retry_seconds=0.2)
        client.run()
        out = client.get_output(input_ids=PROMPT, max_new_tokens=8, priority=1)
        frames = list(client.stream_output(input_ids=[2, 7, 3], max_new_tokens=8, priority=5))
        metrics = client.get_output(get_metrics=True)
        client.close()
    finally:
        server.shutdown()
    assert out["processed"] is True and len(out["generated_tokens"]) >= 8
    assert frames[-1]["processed"] is True and len(frames) >= 2
    assert metrics["requests"] == 2 and metrics["tokens"] >= 8 and metrics["expired"] == 0
    assert set(metrics["by_priority"]) == {"1", "5"} and metrics["priority_inversions"] == 0
    # the process's span totals ride along: where the requests waited and prefilled
    spans = metrics["spans"]
    if kind == "batched":
        assert spans["serve.queue"]["count"] >= 2 and spans["serve.decode"]["count"] >= 2
    else:
        assert spans["engine.prefill"]["count"] >= 2


def test_server_device_defaults_to_cuda(monkeypatch):
    """No fallback: without a device the server builds its engine on cuda,
    and raises where CUDA is not available."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert APIServer(config={}).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        APIServer(config=_config("static"), port=0).start()


def _results():
    """A result of every engine path: static and dynamic generate(), the
    last frame of generate_stream, a batched run() and a ContinuousBatcher
    future, BatcherBackend's last stream frame, an empty request's."""
    (_, _), (pt, pd) = runtimes()
    out = {}
    for kind in ("static", "dynamic"):
        eng = port_engine(kind, pt, pd, tokenizer=WordTokenizer())
        out[kind] = eng.generate(input_ids=np.asarray(PROMPT, np.int32), max_new_tokens=8)
        out[f"{kind} stream"] = {"generated_text": list(eng.generate_stream(
            input_ids=PROMPT, max_new_tokens=8))[-1][0]}
        out[f"{kind} empty"] = eng.generate(input_ids=[], max_new_tokens=8)
    cfg = _config("batched")
    beng = AutoEngine.from_config(device="cpu", **{k: v for k, v in cfg.items()})
    beng.initialize()
    out["batched run"] = beng.run([dict(input_ids=PROMPT, max_new_tokens=8)])[0]
    batcher = ContinuousBatcher(beng)
    batcher.start()
    try:
        out["batcher"] = batcher.submit(input_ids=PROMPT, max_new_tokens=8).result(timeout=120)
        out["batcher stream"] = list(BatcherBackend(batcher).generate_stream(
            input_ids=PROMPT, max_new_tokens=8))[-1][1]
    finally:
        batcher.shutdown()
    return out


def test_every_engine_result_goes_through_send_data():
    """Each engine path's result dict (a numpy prompt echoed included), as the
    server sends it, is JSON: send_data writes it and the other side reads
    it back; jsonable turns numpy and torch values into numbers and lists
    and drops callables."""
    for name, result in _results().items():
        message = APIServer._processed(result, req_id=name)
        a, b = socket.socketpair()
        with a, b:
            api_utils.send_data(a, message)
            got = jax_api_utils.receive_data(b)
        assert got == json.loads(json.dumps(message)) and got["req_id"] == name
        assert got["processed"] is True and isinstance(got["generated_text"], str), name
    value = {"a": np.int32(3), "b": np.arange(3), "c": torch.tensor([1.5]), "d": np.float32(0.5),
             "e": [np.bool_(True), (1, torch.tensor(2))], "_admit_cb": print, "_p": 1}
    assert jsonable(value) == {"a": 3, "b": [0, 1, 2], "c": [1.5], "d": 0.5, "e": [True, [1, 2]],
                               "_p": 1}


def test_templates_equal_jax():
    """TEMPLATES and the three dict views equal JAX's, string for string."""
    assert {k: vars(t) for k, t in templates.TEMPLATES.items()} == \
        {k: vars(t) for k, t in jax_templates.TEMPLATES.items()}
    for name in ("Prompts", "SysPrompts", "ExtraPrompts"):
        assert getattr(templates, name) == getattr(jax_templates, name)
    t = templates.TEMPLATES["llama3-code"]
    assert t.render_first("hi") == jax_templates.TEMPLATES["llama3-code"].render_first("hi")


def _jax_gradio_chat():
    """The JAX package's app/gradio_chat.py, loaded as tests/test_apps.py does."""
    old_argv = sys.argv
    sys.argv = ["gradio_chat.py", "--configuration",
                str(ROOT / "configs" / "chat_config_8b_v5e.json")]
    try:
        spec = importlib.util.spec_from_file_location("jax_gradio_chat", ROOT / "app" /
                                                      "gradio_chat.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        sys.argv = old_argv


HISTORIES = [
    [("what is 2+2", "it is 4\n\n`Output Tokens 5 | TPOT 1.0 ms`"), ("and doubled?", "8")],
    [{"role": "user", "content": "first question"},
     {"role": "assistant", "content": "first answer"},
     {"role": "user", "content": "second question"},
     {"role": "assistant", "content": "second answer\n\n`Avg Accept Tokens 2.00 | TPOT 1.00 ms`"},
     {"role": "user", "content": ["an image"]}],
    [], None, [("only a question", None)],
]


def test_gradio_history_context_equals_jax():
    """gradio_chat._history_context and _strip_perf equal JAX's on
    tests/test_apps.py's histories (and an unanswered turn); the module
    imports without gradio."""
    jax_mod = _jax_gradio_chat()
    for history in HISTORIES:
        assert gradio_chat._history_context(history) == jax_mod._history_context(history)
    for text in ("it is 4\n\n`TPOT 1.0 ms`", "plain", "a `b`", ""):
        assert gradio_chat._strip_perf(text) == jax_mod._strip_perf(text)
    assert "TPOT" not in gradio_chat._history_context(HISTORIES[0])


def test_gradio_chat_fn_streams_through_both_backends():
    """The gradio callback over the static engine and over a batched engine
    (make_backend wraps it in a ContinuousBatcher): growing answers, each
    with its perf log, the last one the full answer."""
    (_, _), (pt, pd) = runtimes()
    beng = AutoEngine.from_config(device="cpu", **_config("batched"))
    beng.initialize()
    for engine in (port_engine("static", pt, pd, tokenizer=WordTokenizer()), beng):
        backend = gradio_chat.make_backend(engine)
        try:
            outs = list(gradio_chat.chat_fn(backend, "meta-llama3")(
                "hello", [("hi", "there")], 0.0, 0.9, 1.0, 16))
        finally:
            if isinstance(backend, BatcherBackend):
                backend.batcher.shutdown()
        answers = [gradio_chat._strip_perf(o) for o in outs]
        assert len(outs) >= 2 and all(o.endswith("`") for o in outs)
        assert all(b.startswith(a.strip()) for a, b in zip(answers, answers[1:]))
        assert len(answers[-1].split()) >= 16


def test_chatbot_turns_through_prefill_append_and_decode(capsys):
    """The chatbot's loop on a tiny engine: the first turn prefills, the
    second appends to the same context, each streams an answer, "exit" ends
    the chat."""
    (_, _), (pt, pd) = runtimes()
    eng = port_engine("static", pt, pd, tokenizer=WordTokenizer(), stop_distance=4)
    lines = iter(["hello", "more", "exit"])
    calls = []
    prefill, append = eng.prefill, eng.append
    eng.prefill = lambda text: calls.append("prefill") or prefill(text)
    eng.append = lambda text: calls.append("append") or append(text)
    assert chatbot.chat(eng, "meta-llama3", 8, 16, read=lambda _prompt: next(lines)) == 2
    assert calls == ["prefill", "append"]
    assert capsys.readouterr().out.count("Assistant: ") == 2


def test_api_app_serves_a_chat_request():
    """app/api.py's demo on the CPU over a config dict: the server builds the
    static engine, the client's chat prompt gets an answer."""
    out = api_app.main(["--device", "cpu", "--port", "0", "--max-new-tokens", "8"],
                       config=_config("static", template="meta-llama3"))
    assert out["processed"] is True and len(out["generated_tokens"]) >= 8
    assert out["generated_text"] == " ".join(
        f"{i}." if i % 5 == 0 else str(i) for i in out["generated_tokens"])
