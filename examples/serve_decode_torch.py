"""Serving example on the PyTorch port: batched decode with KV caches
through the real model substrate (smoke-sized config). The counterpart of
``examples/serve_decode.py``, with its flags and printed lines plus
``--device`` (the card by default, ``cpu`` for the CPU): the prefill's
attention runs the ``flash_attention`` kernel, one launch an attention
layer, and every decode step the ``decode_attention`` kernel, one launch
an attention layer. The weights and prompt come from seeded
``torch.Generator``\\ s, so the sampled tokens differ from the reference's.

    PYTHONPATH=src python examples/serve_decode_torch.py --arch gemma2-2b \
        [--device cpu]
"""

import argparse
import time

import torch

from repro_torch import compat
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.models import model as M


def _seconds(device: torch.device) -> float:
    """The host clock, after the card has finished what was queued."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="where the model runs (default: the card)")
    args = ap.parse_args()

    dev = compat.resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    params = M.init(cfg, 0, device=dev)
    prompt = {
        "tokens": torch.randint(
            0, cfg.vocab_size, (args.batch, args.prompt_len),
            generator=torch.Generator(device=dev).manual_seed(1),
            device=dev, dtype=torch.int32,
        )
    }
    if cfg.frontend == "vision_patches":
        prompt["patch_embeds"] = torch.randn(
            (args.batch, cfg.num_patches, cfg.d_model),
            generator=torch.Generator(device=dev).manual_seed(2),
            device=dev, dtype=torch.float32,
        )
    max_len = args.prompt_len + args.new_tokens + (
        cfg.num_patches if cfg.frontend == "vision_patches" else 0
    )
    with torch.no_grad():
        t0 = _seconds(dev)
        logits, caches = M.prefill(cfg, params, prompt, max_len=max_len)
        print(f"prefill {args.prompt_len} tokens x {args.batch}: "
              f"{_seconds(dev)-t0:.2f}s")

        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        outs = [tok]
        t0 = _seconds(dev)
        for _ in range(args.new_tokens - 1):
            logits, caches = M.decode_step(cfg, params, caches, tok)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            outs.append(tok)
        dt = _seconds(dev) - t0
    seq = torch.cat(outs, dim=1)
    print(f"decoded {args.new_tokens} tokens x {args.batch} in {dt:.2f}s "
          f"({args.new_tokens*args.batch/dt:.1f} tok/s)")
    print("sample:", seq[0].tolist())


if __name__ == "__main__":
    main()
