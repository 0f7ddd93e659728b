"""Speculative-decoding smoke demo, the counterpart of the JAX package's
`examples/spec_generate.py`.

    python -m umbrella_tpu_torch.examples.spec_generate \
        --configuration configs/chat_config_8b_v5e.json [--device cpu]
"""
import argparse

from ..app import load_config
from ..speculation.auto_engine import AutoEngine
from ..templates import Prompts, SysPrompts
from ..utils import resolve_device
from . import engine_config


def spec_generate(engine, template: str, prompt: str, max_new_tokens: int = 256) -> dict:
    """Prefill the system prompt and `prompt`, decode, print the JAX example's
    line; returns tokens, seconds, steps, tok/s and accept a step."""
    engine.prefill(SysPrompts[template] + Prompts[template].format(prompt))
    dec_len, elapsed, steps = engine.speculative_decoding(max_new_tokens)
    print(f"\n{dec_len} tokens in {elapsed:.2f}s "
          f"({dec_len/elapsed:.2f} tok/s, {dec_len/steps:.2f} accept/step)")
    return dict(tokens=dec_len, seconds=elapsed, steps=steps, tok_per_s=dec_len / elapsed,
                accept_per_step=dec_len / steps)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--configuration", type=str, default="configs/chat_config_8b_v5e.json")
    parser.add_argument("--prompt", type=str,
                        default="Explain the idea of speculative decoding.")
    parser.add_argument("--max_new_tokens", type=int, default=256)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    config, template, _, _ = load_config(args.configuration)
    engine = AutoEngine.from_config(device=device, **engine_config(config))
    engine.initialize()
    return spec_generate(engine, template, args.prompt, args.max_new_tokens)


if __name__ == "__main__":
    main()
