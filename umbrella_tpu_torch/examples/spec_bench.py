"""MT-Bench speculative-decoding harness, the counterpart of the JAX package's
`examples/spec_bench.py`: per-category Avg Accept Tokens and TPOT over a
question set.

    python -m umbrella_tpu_torch.examples.spec_bench \
        --configuration configs/chat_config_8b_v5e.json [--device cpu] [--limit N]

Questions load from --data (FastChat MT-Bench question.jsonl format); the
default is the bundled sample set, umbrella_tpu_torch/data/question.jsonl.
"""
import argparse
import json
import os
from collections import defaultdict

from ..app import load_config
from ..speculation.auto_engine import AutoEngine
from ..templates import Prompts, SysPrompts
from ..utils import TextColors, resolve_device, setup_logger
from . import DATA_DIR, engine_config

logger = setup_logger()


def load_questions(path):
    questions = []
    with open(path) as f:
        for line in f:
            if line.strip():
                questions.append(json.loads(line))
    return questions


def summarize(s: dict) -> dict:
    """A category's (or the total's) tokens, seconds and steps with the
    derived accept a step, TPOT and tok/s."""
    return dict(s, avg_accept_tokens=s["tokens"] / max(s["steps"], 1),
                tpot_ms=1000 * s["seconds"] / max(s["tokens"], 1),
                tok_per_s=s["tokens"] / max(s["seconds"], 1e-9))


def spec_bench(engine, questions, template: str, max_new_tokens: int = 256) -> dict:
    """Each question's turns on one context (the first prefilled, the others
    appended; a turn the context cannot take ends the question), the engine
    reset after each question. Logs the JAX example's lines; returns
    {"categories": {category: stats}, "total": stats}."""
    stats = defaultdict(lambda: dict(tokens=0, seconds=0.0, steps=0))
    for q in questions:
        cat = q.get("category", "default")
        for turn_idx, turn in enumerate(q["turns"]):
            prompt = Prompts[template].format(turn)
            if turn_idx == 0:
                ok = engine.prefill(SysPrompts[template] + prompt)
            else:
                ok = engine.append(prompt)
            if not ok:
                break
            dec_len, elapsed, steps = engine.speculative_decoding(max_new_tokens)
            s = stats[cat]
            s["tokens"] += dec_len
            s["seconds"] += elapsed
            s["steps"] += steps
        engine.reset()

    total = dict(tokens=0, seconds=0.0, steps=0)
    categories = {}
    for cat, s in sorted(stats.items()):
        categories[cat] = c = summarize(s)
        logger.info(TextColors.colorize(
            "[{}] Avg Accept Tokens {:.2f} | TPOT {:.2f} ms | {:.2f} tok/s".format(
                cat, c["avg_accept_tokens"], c["tpot_ms"], c["tok_per_s"]), "magenta"))
        for k in total:
            total[k] += s[k]
    total = summarize(total)
    logger.info(TextColors.colorize(
        "[TOTAL] Avg Accept Tokens {:.2f} | TPOT {:.2f} ms | {:.2f} tok/s".format(
            total["avg_accept_tokens"], total["tpot_ms"], total["tok_per_s"]), "green"))
    return dict(categories=categories, total=total)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--configuration", type=str, default="configs/chat_config_8b_v5e.json")
    parser.add_argument("--data", type=str, default=os.path.join(DATA_DIR, "question.jsonl"))
    parser.add_argument("--max_new_tokens", type=int, default=256)
    parser.add_argument("--limit", type=int, default=0, help="max questions (0=all)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    config, template, _, _ = load_config(args.configuration)
    engine = AutoEngine.from_config(device=device, **engine_config(config))
    engine.initialize()

    questions = load_questions(args.data)
    if args.limit:
        questions = questions[: args.limit]
    return spec_bench(engine, questions, template, args.max_new_tokens)


if __name__ == "__main__":
    main()
