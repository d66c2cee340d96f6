"""The serving CLI (``repro.launch.serve``): the offline representation
phase (batched document embedding) for any registered architecture.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        [--smoke] [--docs 64] [--out embeds.npy] [--device cpu]

It draws the arch's params from seed 0 on the device (the card unless
``--device cpu``; with ``--smoke`` the arch's reduced config), embeds a
synthetic corpus of ``--docs`` token documents with ``EmbeddingService``
and, with ``--out``, saves the (docs, d_model) float32 embeddings.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.config import get_arch, get_smoke_arch
from repro_torch.data import make_corpus
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.runtime.serve_loop import EmbeddingService, ServeStats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--docs", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--doc-len", type=int, default=48)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_arch(args.arch) if args.smoke else get_arch(args.arch)
    corpus = make_corpus(0, n_docs=args.docs, dim=128, with_tokens=True,
                         vocab=min(cfg.vocab_size, 256),
                         doc_len=args.doc_len)
    params = build_model(cfg).init(torch.Generator(dev).manual_seed(0))
    service = EmbeddingService(cfg, params, batch_size=args.batch,
                               device=dev)
    stats = ServeStats()
    embeds = service.embed_documents(
        [corpus.tokens[i] for i in range(args.docs)], stats)
    print(f"embedded {stats.documents} docs ({cfg.name}, d={cfg.d_model}) "
          f"in {stats.wall_s:.1f}s, {stats.batches} batches, "
          f"pad waste {stats.pad_waste_frac:.1%}")
    if args.out:
        np.save(args.out, embeds)
        print(f"saved -> {args.out}")
    return embeds


if __name__ == "__main__":
    main()
