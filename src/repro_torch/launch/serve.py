"""Serving launcher: prefill + batched decode loop with a static KV/SSM cache.

Counterpart of ``repro.launch.serve``. Runs on the GPU unless asked
otherwise:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
        --reduced --device cpu --prompt-len 16 --decode-steps 8

Every arch of ``configs.ARCHS`` but musicgen-medium, whose audio frontend
takes frame embeddings in place of tokens: drive it through
``launch.steps`` as the CLI's refusal says. qwen2-moe-a2.7b needs
``param_dtype="bfloat16"`` on an 80 GB card (``serve`` with ``params=``
or a config made with ``dataclasses.replace``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import prng, resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.steps import (_cast_params, make_decode_step,
                                      make_prefill_decode)
from repro_torch.models import init_decode_state, init_params


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _next_token(logits, vocab: int, temperature: float, key):
    """Greedy argmax over the real vocab, or a sample at ``temperature`` as
    ``jax.random.categorical(key, logits / temperature)`` draws it: the
    argmax of logits plus one (B, V) block of gumbel noise from one key
    (``prng.categorical`` takes one key per distribution)."""
    lg = logits[:, :vocab]
    if temperature > 0:
        # A true division: torch divides by a host scalar through its
        # reciprocal on the GPU, so the divisor is a tensor made there.
        t = torch.full((), temperature, dtype=torch.float32, device=lg.device)
        lg = lg / t + prng.gumbel(key, tuple(lg.shape))
    return torch.argmax(lg, dim=-1)[:, None].to(torch.int32)


def serve(cfg, batch: int, prompt_len: int, decode_steps: int,
          temperature: float = 0.0, device=None, *, params=None):
    """Prefill a random prompt (``prng.randint`` of ``fold_in(PRNGKey(0),
    1)``, as the JAX launcher draws it) through the cache, then decode
    ``decode_steps`` tokens. ``params`` default to ``init_params(PRNGKey(0),
    cfg)``. Returns (tokens (batch, decode_steps) int32, prefill seconds,
    decode seconds), each time ending in a synchronise."""
    dev = resolve_device(device)
    key = prng.PRNGKey(0, dev)
    if params is None:
        params = init_params(key, cfg)
    # The steps cast the weights to the compute type on every call, as the
    # JAX steps do; cast once here and the steps' own casts change nothing.
    params = _cast_params(params, cfg)
    max_len = prompt_len + decode_steps + 1
    state = init_decode_state(cfg, batch, max_len, dev)
    step = make_decode_step(cfg)
    prefill_step = make_prefill_decode(cfg)

    prompt = prng.randint(prng.fold_in(key, 1), (batch, prompt_len), 0, cfg.vocab)
    _sync(dev)
    t0 = time.perf_counter()
    logits, state = prefill_step(params, state, {"tokens": prompt})
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tokens = []
    t0 = time.perf_counter()
    tok = _next_token(logits, cfg.vocab, 0.0, None)
    for _ in range(decode_steps):
        tokens.append(tok)
        logits, state = step(params, state, {"tokens": tok})
        sk = None
        if temperature > 0:
            key, sk = prng.split(key)
        tok = _next_token(logits, cfg.vocab, temperature, sk)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    out = (torch.cat(tokens, dim=1) if tokens
           else torch.zeros((batch, 0), dtype=torch.int32, device=dev))
    return out, t_prefill, t_decode


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' for the plain path)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.frontend == "audio_stub":
        # The reference's refusal; the port has no dry-run cells, so it
        # names the steps that take frame embeddings.
        raise SystemExit("audio arch serving needs frame embeddings; drive musicgen "
                         "through launch.steps (make_prefill_decode, make_decode_step)")
    out, tp, td = serve(cfg, args.batch, args.prompt_len, args.decode_steps,
                        args.temperature, device=args.device)
    print(f"[serve] {cfg.name}: batch={args.batch} prompt={args.prompt_len} "
          f"decoded={out.shape[1]} tokens on {resolve_device(args.device)}")
    if args.decode_steps:
        print(f"[serve] prefill {tp*1e3:.0f} ms, decode "
              f"{td/args.decode_steps*1e3:.1f} ms/token "
              f"({args.batch*args.decode_steps/td:.0f} tok/s)")
    print(f"[serve] sample row: {out[0, :16].tolist()}")


if __name__ == "__main__":
    main()
