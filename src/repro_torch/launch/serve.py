"""Batched serving launcher: one batched generation round over a set of
requests.

``python -m repro_torch.launch.serve --arch <id> [--reduced] --requests 16``

The PyTorch port's counterpart of the JAX package's ``launch/serve.py``:
prompts left-padded (no mask) into one batch, ``Model.prefill`` builds the
caches, then a decode loop emits one greedy token per sequence per step
until each request has its ``max_new``. On one device (``--device``,
default ``cuda``); the weights are drawn from ``--seed``. An
encoder-decoder's requests carry the stub frontend's source frames
(``src_embeds``): ``main`` draws them from the seed, one frame per prompt
token.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from .. import device as _device
from ..configs import REGISTRY, get_config, reduced_config
from ..models import build_model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)


def serve_batch(model, requests: List[Request],
                src_embeds: Optional[np.ndarray] = None) -> List[Request]:
    """One batched generation round: pad prompts, prefill, decode loop.

    Greedy argmax over the real vocabulary; request i takes the first
    ``max_new`` tokens of its row. The cache holds the longest prompt plus
    the most new tokens plus one. ``src_embeds`` (B, S_src, D): an
    encoder-decoder's source frames, one row per request."""
    dev = model.device
    bsz = len(requests)
    plen = max(len(r.prompt) for r in requests)
    toks = np.zeros((bsz, plen), np.int32)
    for i, r in enumerate(requests):
        toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
    max_new = max(r.max_new for r in requests)
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    if src_embeds is not None:
        batch["src_embeds"] = torch.as_tensor(src_embeds, device=dev)

    v = model.cfg.vocab_size
    logits, cache = model.prefill(batch, max_len=plen + max_new + 1)
    nxt = torch.argmax(logits[:, :v], dim=-1).to(torch.int32)
    for step in range(max_new):
        host = nxt.tolist()
        for i, r in enumerate(requests):
            if step < r.max_new:
                r.out.append(host[i])
        logits, cache = model.decode_step(cache, nxt[:, None])
        nxt = torch.argmax(logits[:, :v], dim=-1).to(torch.int32)
    return requests


def main(argv=None) -> List[Request]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(REGISTRY))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=args.prompt_len),
                    max_new=args.max_new)
            for i in range(args.requests)]
    src = None
    if cfg.family == "encdec":
        src = rng.standard_normal(
            (args.requests, args.prompt_len, cfg.d_model)).astype(np.float32)
    t0 = time.time()
    reqs = serve_batch(model, reqs, src_embeds=src)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    n_tok = sum(len(r.out) for r in reqs)
    print(f"[serve] {len(reqs)} requests, {n_tok} tokens "
          f"in {dt:.2f}s ({n_tok/dt:.1f} tok/s batched)")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {r.out}")
    return reqs


if __name__ == "__main__":
    main()
