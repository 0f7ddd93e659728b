"""Command-line apps over the port: `python -m umbrella_tpu_torch.app.<name>
--configuration configs/<file>.json [--device cuda]` with <name> one of
chatbot, api and gradio_chat (the counterparts of the JAX package's `app/`)."""
import argparse
import json


def parse_args(argv, **extra):
    """--configuration and --device (default cuda; cpu runs the plain versions
    of the kernels), plus `extra` options as name=(type, default)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--configuration", type=str, default="configs/chat_config_8b_v5e.json")
    parser.add_argument("--device", type=str, default="cuda")
    for name, (kind, default) in extra.items():
        parser.add_argument(f"--{name.replace('_', '-')}", type=kind, default=default)
    return parser.parse_args(argv)


def load_config(path: str):
    """A config file as (engine config, template, generation_length,
    max_turns): the three app keys taken out of the engine's config."""
    with open(path) as f:
        config = json.load(f)
    template = config.pop("template", "meta-llama3")
    generation_length = config.pop("generation_length", 256)
    max_turns = config.pop("max_turns", 16)
    return config, template, generation_length, max_turns
