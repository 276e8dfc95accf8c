"""Batched serving: prefill a prompt batch, then greedy-decode new tokens
through the KV cache.

The port of ``examples/serve_lm.py``, on the card by default, at the
published configuration unless ``--reduced`` is given:

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch gemma2-2b
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch paligemma-3b \\
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_lm \\
        --arch recurrentgemma-9b --batch 2 --prompt-len 4096 --tokens 16

Weights, prompts, the VLM's patch embeddings (B, vision_tokens,
vision_dim) and whisper's frame embeddings (B, encoder_seq, d_model) are
drawn from ``--seed`` (bf16 weights at full size, fp32 with ``--reduced``,
as the reference's example runs). Every architecture of the registry is
served: the dense, moe and vlm families (qwen1.5-32b with its config's int8
KV cache) through ``TransformerLM``, whisper-medium, mamba2-780m and
recurrentgemma-9b through ``WhisperModel``, ``MambaLM`` and ``GriffinLM``.
The cache holds the image prefix, the prompt and every generated token:
``max_len = vision_tokens + prompt_len + tokens + 1``, where the
reference's example leaves out the prefix and its decode overwrites the
cache's last slot (ROADMAP R12).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.graphs.device import resolve_device
from repro_torch.models.registry import get_config, get_model, get_reduced_config
from repro_torch.train.serve_step import greedy_generate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="the same-family scale-down instead of the "
                         "published configuration")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain paths")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    dtype = torch.float32 if args.reduced else torch.bfloat16
    model = get_model(cfg, device=dev, dtype=dtype)
    model.init(torch.Generator(device=dev).manual_seed(args.seed))
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    batch = {"tokens": prompts}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(
            (args.batch, cfg.vision_tokens, cfg.vision_dim),
            generator=torch.Generator(device=dev).manual_seed(args.seed + 2),
            device=dev, dtype=torch.float32).to(dtype)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            (args.batch, cfg.encoder_seq, cfg.d_model),
            generator=torch.Generator(device=dev).manual_seed(args.seed + 2),
            device=dev, dtype=torch.float32).to(dtype)
    max_len = cfg.vision_tokens + args.prompt_len + args.tokens + 1
    t0 = time.perf_counter()
    out = greedy_generate(model, cfg, batch, steps=args.tokens,
                          max_len=max_len)
    first = out[0].tolist()  # waits for the device
    dt = time.perf_counter() - t0
    total = args.batch * args.tokens
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"generated={args.tokens}/seq")
    if cfg.family == "vlm":
        print(f"image prefix: {cfg.vision_tokens} patch tokens of width "
              f"{cfg.vision_dim}")
    if cfg.family == "encdec":
        print(f"audio frames: {cfg.encoder_seq} of width {cfg.d_model} "
              f"(the frontend stub)")
    print(f"output token ids (first sequence): {first}")
    print(f"{total} tokens in {dt:.2f}s = {total / dt:.1f} tok/s ({where}; "
          f"on a card the first call includes the kernel build)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
