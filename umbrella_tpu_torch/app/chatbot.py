"""Multi-turn command-line chat, the counterpart of the JAX package's `app/chatbot.py`.

    python -m umbrella_tpu_torch.app.chatbot --configuration configs/chat_config_8b_v5e.json

The first turn prefills the system prompt and the user turn, each later turn
appends to the same context; the answer streams through speculative_decoding.
"""
from ..speculation.auto_engine import AutoEngine
from ..templates import ExtraPrompts, Prompts, SysPrompts
from ..utils import TextColors
from . import load_config, parse_args


def chat(engine, template: str, generation_length: int, max_turns: int, read=input):
    """Up to max_turns turns; `read` gives each user line (EOF, "exit" or
    "quit" ends the chat). Returns the turns answered."""
    system_prompt = SysPrompts.get(template, "")
    user_template = Prompts.get(template, "{}")
    extra = ExtraPrompts.get(template, "")
    for turn in range(max_turns):
        try:
            text = read(TextColors.colorize("User: ", "green"))
        except EOFError:
            return turn
        if text.strip().lower() in ("exit", "quit"):
            return turn
        prompt = user_template.format(text + extra)
        ok = engine.prefill(system_prompt + prompt) if turn == 0 else engine.append(prompt)
        if not ok:
            print(TextColors.colorize("Context limit reached.", "red"))
            return turn
        print(TextColors.colorize("Assistant: ", "cyan"), end="", flush=True)
        engine.speculative_decoding(max_new_tokens=generation_length)
    return max_turns


def main(argv=None):
    args = parse_args(argv)
    config, template, generation_length, max_turns = load_config(args.configuration)
    engine = AutoEngine.from_config(device=args.device, **config)
    engine.initialize()
    chat(engine, template, generation_length, max_turns)


if __name__ == "__main__":
    main()
