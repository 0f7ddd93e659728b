"""Code-completion speculative-decoding harness, the counterpart of the JAX
package's `examples/spec_bench_python.py`: feeds code prompts (>=20 tokens)
and reports Avg Accept Tokens and tok/s.

    python -m umbrella_tpu_torch.examples.spec_bench_python \
        --configuration configs/code_config_8b_awq_v5e.json [--device cpu]

Dataset: a JSONL file with {"prompt": ...} records (--data); without one, the
five DEFAULT_PROMPTS below.
"""
import argparse
import json

from ..speculation.auto_engine import AutoEngine
from ..templates import ExtraPrompts, Prompts, SysPrompts
from ..utils import TextColors, resolve_device, setup_logger
from . import engine_config
from .spec_bench import summarize

logger = setup_logger()

DEFAULT_PROMPTS = [
    "Write a Python function to compute the edit distance between two strings using dynamic programming.",
    "Implement Dijkstra's shortest path algorithm over an adjacency list with a binary heap.",
    "Write a Python class implementing an LRU cache with O(1) get and put.",
    "Implement quicksort with median-of-three pivot selection in Python.",
    "Write a function that parses an ISO-8601 timestamp without using datetime.fromisoformat.",
]


def spec_bench_python(engine, prompts, template: str, max_new_tokens: int = 512) -> dict:
    """Each prompt on a fresh context. Where the engine has a tokenizer,
    prompts of fewer than 20 tokens are skipped; a prompt the context cannot
    take is skipped too. Logs the JAX example's [CODE] line; returns the
    totals with the indices of the prompts decoded (`kept`)."""
    tok = engine.tokenizer
    total = dict(tokens=0, seconds=0.0, steps=0)
    kept = []
    for i, prompt in enumerate(prompts):
        if tok is not None and len(tok.encode(prompt)) < 20:
            continue  # the short-prompt filter
        text = SysPrompts[template] + Prompts[template].format(
            prompt + ExtraPrompts.get(template, ""))
        if not engine.prefill(text):
            continue
        dec_len, elapsed, steps = engine.speculative_decoding(max_new_tokens)
        total["tokens"] += dec_len
        total["seconds"] += elapsed
        total["steps"] += steps
        kept.append(i)
        engine.reset()

    total = summarize(total)
    logger.info(TextColors.colorize(
        "[CODE] Avg Accept Tokens {:.2f} | TPOT {:.2f} ms | {:.2f} tok/s".format(
            total["avg_accept_tokens"], total["tpot_ms"], total["tok_per_s"]), "green"))
    return dict(total, kept=kept)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--configuration", type=str,
                        default="configs/code_config_8b_awq_v5e.json")
    parser.add_argument("--data", type=str, default="")
    parser.add_argument("--max_new_tokens", type=int, default=512)
    parser.add_argument("--limit", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    with open(args.configuration) as f:
        config = json.load(f)
    template = config.pop("template", "llama3-code")
    config.pop("generation_length", None)
    config.pop("max_turns", None)
    engine = AutoEngine.from_config(device=device, **engine_config(config))
    engine.initialize()

    if args.data:
        with open(args.data) as f:
            prompts = [json.loads(line)["prompt"] for line in f if line.strip()]
    else:
        prompts = DEFAULT_PROMPTS
    if args.limit:
        prompts = prompts[: args.limit]
    return spec_bench_python(engine, prompts, template, args.max_new_tokens)


if __name__ == "__main__":
    main()
