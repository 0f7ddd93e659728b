"""Gradio streaming chat, the counterpart of the JAX package's `app/gradio_chat.py`.

    python -m umbrella_tpu_torch.app.gradio_chat --configuration configs/chat_config_8b_v5e.json

Needs the `gradio` package to run; the module imports without it. Each
request carries the whole conversation, and the chat shows the partial text
of the engine's generate_stream frames as they come.
"""
try:
    import gradio as gr
except ImportError:  # pragma: no cover
    gr = None

from ..speculation.auto_engine import AutoEngine
from ..templates import Prompts, SysPrompts
from . import load_config, parse_args


def _strip_perf(text: str) -> str:
    """Drop the trailing "\\n\\n`perf log`" that chat() appends for display."""
    if text.endswith("`") and "\n\n`" in text:
        return text.rsplit("\n\n`", 1)[0]
    return text


def _history_context(history, template: str = "meta-llama3") -> str:
    """The prompt of all earlier turns. Takes both gradio history formats:
    (user, assistant) pairs and role/content message dicts."""
    context = ""
    pending_user = None
    for turn in history or []:
        if isinstance(turn, dict):  # "messages" format
            content = turn.get("content", "")
            if not isinstance(content, str):
                continue
            if turn.get("role") == "user":
                pending_user = content
            elif turn.get("role") == "assistant" and pending_user is not None:
                context += Prompts[template].format(pending_user) + _strip_perf(content)
                pending_user = None
        else:  # tuple format
            user_msg, bot_msg = turn
            context += Prompts[template].format(user_msg) + _strip_perf(bot_msg or "")
    return context


def make_backend(engine):
    """The single-request engines stream themselves; a BatchedStaticEngine
    ("engine": "batched_static") streams through a ContinuousBatcher and a
    BatcherBackend."""
    if hasattr(engine, "generate_stream"):
        return engine
    from ..serving.batched_engine import ContinuousBatcher
    from ..serving.scheduler import BatcherBackend

    batcher = ContinuousBatcher(engine)
    batcher.start()
    return BatcherBackend(batcher)


def _fmt_perf(perf) -> str:
    if isinstance(perf, dict):  # the batched path's last frame carries the result dict
        return "Avg Accept Tokens {:.2f} | TPOT {:.2f} ms".format(
            perf.get("avg_accept_tokens", 0) or 0, perf.get("time_per_output_token", 0) or 0)
    return str(perf)


def chat_fn(backend, template: str):
    """gradio's chat callback over `backend`: yields the partial answer with
    its perf log."""
    def chat(message, history, temperature, topp, repetition_penalty, max_new_tokens):
        context = (SysPrompts[template] + _history_context(history, template)
                   + Prompts[template].format(message))
        stream = backend.generate_stream(
            context=context, max_new_tokens=int(max_new_tokens), temperature=float(temperature),
            topp=float(topp), repetition_penalty=float(repetition_penalty))
        for partial_text, perf_log in stream:
            yield partial_text + f"\n\n`{_fmt_perf(perf_log)}`"
    return chat


def build_app(backend, template: str = "meta-llama3"):
    return gr.ChatInterface(
        chat_fn(backend, template),
        additional_inputs=[
            gr.Slider(0.0, 1.5, value=0.6, label="temperature"),
            gr.Slider(0.1, 1.0, value=0.9, label="top-p"),
            gr.Slider(1.0, 1.5, value=1.05, label="repetition penalty"),
            gr.Slider(16, 1024, value=256, step=16, label="max new tokens"),
        ],
        title="umbrella_tpu_torch chat",
    )


def main(argv=None):
    if gr is None:
        raise SystemExit("gradio is not installed; pip install gradio to use this app")
    args = parse_args(argv)
    config, template, _, _ = load_config(args.configuration)
    engine = AutoEngine.from_config(device=args.device, **config)
    engine.initialize()
    build_app(make_backend(engine), template).launch()


if __name__ == "__main__":
    main()
