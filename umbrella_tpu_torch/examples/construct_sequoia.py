"""Offline Sequoia tree construction, the counterpart of the JAX package's
`examples/construct_sequoia.py`: measure positional acceptance rates of a
(draft, target) pair by teacher-forcing a corpus through both models, then
run the greedy DP tree builder.

    python -m umbrella_tpu_torch.examples.construct_sequoia \
        --draft_model <dir> --target_model <dir> [--width 5 --depth 6] [--device cpu]

acceptance[k] = P(target argmax is the draft's (k+1)-th choice); any text
corpus works (--corpus, one document a line). The tokenizer is the target
directory's, through `transformers` (imported only then).
"""
import argparse

import numpy as np
import torch

from ..models.auto_model import AutoModelLM
from ..ops.masks import causal_mask_rows
from ..sequoia import generate_sequoia_tree
from ..utils import resolve_device

DEFAULT_TEXTS = [
    "def quicksort(arr):\n    if len(arr) <= 1:\n        return arr\n    pivot = arr[len(arr) // 2]\n    left = [x for x in arr if x < pivot]\n    mid = [x for x in arr if x == pivot]\n    right = [x for x in arr if x > pivot]\n    return quicksort(left) + mid + quicksort(right)",
    "The quick brown fox jumps over the lazy dog. Pack my box with five dozen liquor jugs.",
    "In machine learning, speculative decoding accelerates autoregressive generation by letting a small draft model propose tokens that a large target model verifies in parallel.",
]


def _logits(runtime, ids, max_len):
    """fp32 logits of a causal forward of ids over a fresh cache of max_len slots."""
    dev = runtime.device
    S = len(ids)
    kv = runtime.init_kv()
    return runtime.forward(runtime.params, kv, torch.as_tensor(ids, device=dev),
                           torch.arange(S, device=dev),
                           causal_mask_rows(0, S, max_len, device=dev), 0)[0]


def measure_acceptance(draft, target, token_seqs, num_beams=8, max_len=1024):
    """Positional acceptance vector over a list of token id sequences: each is
    cut to max_len - 8 tokens, and one of fewer than 8 is skipped."""
    counts = np.zeros(num_beams)
    total = 0
    for ids in token_seqs:
        ids = np.asarray(ids[:max_len - 8], np.int32)
        S = len(ids)
        if S < 8:
            continue
        t_arg = torch.argmax(_logits(target, ids, max_len), -1)
        d_top = torch.topk(_logits(draft, ids, max_len), num_beams, dim=-1).indices
        counts += (d_top == t_arg[:, None].to(d_top.device)).sum(0).cpu().numpy()
        total += S
    probs = counts / max(total, 1)
    return probs.tolist()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--draft_model", type=str, required=True)
    parser.add_argument("--target_model", type=str, required=True)
    parser.add_argument("--width", type=int, default=5)
    parser.add_argument("--depth", type=int, default=6)
    parser.add_argument("--num_beams", type=int, default=8)
    parser.add_argument("--corpus", type=str, default="",
                        help="text file, one document per line")
    parser.add_argument("--output", type=str, default="")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from transformers import AutoTokenizer

    target = AutoModelLM.from_pretrained(args.target_model, max_length=1024, device=device)
    draft = AutoModelLM.from_pretrained(args.draft_model, max_length=1024, device=device)
    tokenizer = AutoTokenizer.from_pretrained(args.target_model)

    if args.corpus:
        with open(args.corpus) as f:
            texts = f.read().splitlines()
    else:
        texts = DEFAULT_TEXTS
    seqs = [tokenizer.encode(t) for t in texts if t.strip()]
    acc = measure_acceptance(draft, target, seqs, num_beams=args.num_beams)
    print("measured acceptance:", [round(a, 4) for a in acc])

    out = args.output or f"sequoia_tree-{args.width}x{args.depth}.json"
    generate_sequoia_tree(args.width, args.depth, acc=acc, json_file=out)
    print("wrote", out)
    return acc, out


if __name__ == "__main__":
    main()
