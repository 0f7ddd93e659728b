"""Plain autoregressive generation demo, the counterpart of the JAX package's
`examples/generate.py`: loads one model and greedy/stochastic-decodes a
prompt, logging TPOT.

    python -m umbrella_tpu_torch.examples.generate --model <checkpoint dir> [--device cpu]

The model is a checkpoint directory with its tokenizer (loaded through
`transformers`, imported only then).
"""
import argparse
import time

import torch

from ..cuda_graphs import Phase
from ..models.auto_model import AutoModelLM
from ..ops.masks import causal_mask_rows
from ..ops.sampling import sample_top_k_top_p_rows
from ..utils import TextColors, resolve_device, setup_logger
from . import step_runner, synchronize

logger = setup_logger()


def autoregressive_decode(runtime, input_ids, max_new_tokens=128, greedy=True,
                          temperature=0.6, topk=32, topp=0.9, seed=0):
    """Token-at-a-time decode; returns (tokens, tpot_ms).

    A causal prefill, then one token a step. The step (forward of the last
    token at its slot, then argmax or a top-k / top-p draw from a
    torch.Generator seeded with `seed`) reads and writes device buffers only:
    on the card it is captured once as a CUDA graph and replayed, on the CPU
    it runs eagerly. The first token is the prefill's argmax even when
    sampling, as in the JAX example. The tokens are read back once, after the
    timed steps."""
    dev = runtime.device
    L = runtime.max_length
    n = len(input_ids)
    kv = runtime.init_kv()
    gen = torch.Generator(device=dev).manual_seed(seed)
    tok = torch.zeros(1, dtype=torch.int32, device=dev)
    t = torch.full((), n, dtype=torch.int32, device=dev)
    out = torch.zeros(max_new_tokens + 1, dtype=torch.int32, device=dev)
    sampling = [torch.tensor(v, dtype=torch.float32, device=dev) for v in (temperature, topp)]

    def inputs():
        return tok, t.reshape(1), causal_mask_rows(t, 1, L, device=dev), t

    def sample(logits):
        if greedy:
            nxt = torch.argmax(logits[0]).to(torch.int32).reshape(1)
        else:
            nxt = sample_top_k_top_p_rows(gen, logits[:1], sampling[0], topk, sampling[1])
        out.index_copy_(0, (t - (n - 1)).reshape(1).long(), nxt)
        tok.copy_(nxt)
        t.add_(1)

    phases = [Phase("inputs", dev, inputs, (), ("ids", "pos", "mask", "nn")),
              *runtime.forward_phases(kv), Phase("sample", dev, sample, ("logits",))]
    # captured before the prefill: the capture's eager run writes slot n and
    # out[1], which the first step writes again
    step = step_runner(phases, dev, () if greedy else (gen,))
    ids = torch.as_tensor(input_ids, dtype=torch.int32, device=dev)
    logits, _ = runtime.forward(runtime.params, kv, ids, torch.arange(n, device=dev),
                                causal_mask_rows(0, n, L, device=dev), 0)
    tok.copy_(torch.argmax(logits[-1]).to(torch.int32).reshape(1))
    out[0] = tok[0]
    t.fill_(n)
    synchronize(dev)
    t0 = time.time()
    step(max_new_tokens - 1)
    synchronize(dev)
    dt = time.time() - t0
    toks = out[:max_new_tokens].tolist()
    return toks, 1000 * dt / max(len(toks) - 1, 1)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default="meta-llama/Llama-3.2-1B-Instruct")
    parser.add_argument("--prompt", type=str, default="Tell me what you know about Reinforcement Learning in 100 words.")
    parser.add_argument("--max_new_tokens", type=int, default=128)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from transformers import AutoTokenizer

    runtime = AutoModelLM.from_pretrained(args.model, max_length=2048, device=device)
    tokenizer = AutoTokenizer.from_pretrained(args.model)
    ids = tokenizer.encode(args.prompt)
    toks, tpot = autoregressive_decode(
        runtime, ids, max_new_tokens=args.max_new_tokens,
        greedy=args.temperature < 0.05, temperature=args.temperature)
    print(tokenizer.decode(toks, skip_special_tokens=True))
    logger.info(TextColors.colorize(f"TPOT {tpot:.2f} ms", "magenta"))
    return toks, tpot


if __name__ == "__main__":
    main()
