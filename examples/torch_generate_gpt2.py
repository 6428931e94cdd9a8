#!/usr/bin/env python
"""Autoregressive generation and continuous batching through the
PyTorch/CUDA port, ``mxnet_tpu_torch``: the counterpart of
``examples/generate_gpt2.py``, with its flags plus ``--device`` (``gpu``,
the default, or ``cpu``).

Builds a GPT-2 (seeded random weights), stands up the generation engine
(bucketed prefill + one decode step, each one CUDA graph on the card) and
serves a burst of mixed-length requests through the continuous batcher,
printing per-request TTFT and tokens:

  python examples/torch_generate_gpt2.py --device cpu
  python examples/torch_generate_gpt2.py --model gpt2_117m --batch-size 8
  python examples/torch_generate_gpt2.py --paged --num-pages 24
  python examples/torch_generate_gpt2.py --paged --speculate 4
  python examples/torch_generate_gpt2.py --share-prefix --samples 4

``--paged`` swaps the dense per-slot cache for the page-pool cache
(admission bounded by free pages; pages in use printed) and
``--speculate k`` adds self-drafting speculative decoding on top (accept
rate printed; greedy tokens stay identical). ``--share-prefix`` turns on
the radix prefix cache and gives every request the same system-prompt
head (prefix hits and CoW copies printed); ``--samples N`` draws N
parallel samples from ONE prompt: the first prefills, the other N-1 are
admitted by copy-on-write fork.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mxnet_tpu_torch.inference import (ContinuousBatcher, GenerationEngine,  # noqa: E402
                                       SamplingConfig)
from mxnet_tpu_torch.models import gpt2  # noqa: E402
from mxnet_tpu_torch.observability import REGISTRY  # noqa: E402


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="gpt2_tiny", choices=list(gpt2.gpt2_configs))
    ap.add_argument("--vocab", type=int, default=2048,
                    help="trimmed vocab so the demo stays CPU-friendly")
    ap.add_argument("--batch-size", type=int, default=4,
                    help="decode slots (static batch rows)")
    ap.add_argument("--max-length", type=int, default=256)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new-tokens", type=int, default=24)
    ap.add_argument("--sampling", default="greedy",
                    choices=["greedy", "temperature", "top_k"])
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: global page pool + per-row page "
                         "tables")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="pool capacity in pages (default: dense-equivalent)")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="self-drafting speculative decode, K tokens/round "
                         "(implies --paged)")
    ap.add_argument("--share-prefix", action="store_true",
                    help="radix prefix cache (implies --paged): every "
                         "request shares a system-prompt head; hit rate "
                         "and CoW copies printed")
    ap.add_argument("--samples", type=int, default=1, metavar="N",
                    help="N-way parallel sampling from ONE prompt via "
                         "copy-on-write fork (implies --paged; switches "
                         "greedy to temperature so samples can diverge)")
    ap.add_argument("--device", default="gpu", choices=("gpu", "cpu"))
    return ap


def _total(name):
    c = REGISTRY.get(name)
    return int(c.total()) if c else 0


def main(argv=None, net=None):
    """Serve the flags' burst and print it; return a dict of what was
    printed (requests with their tokens, programs, pages, prefix sharing,
    the accept rate). ``net`` replaces the GPT-2 the flags describe (on
    the device, its vocabulary ``--vocab``)."""
    args = build_parser().parse_args(argv)
    device = "cpu" if args.device == "cpu" else "cuda"
    if net is None:
        net = gpt2.get_gpt2(args.model, dropout=0.0, vocab_size=args.vocab,
                            max_length=args.max_length, device=device,
                            seed=0)

    paged = (args.paged or args.speculate > 0 or args.share_prefix
             or args.samples > 1)
    method = args.sampling
    if args.samples > 1 and method == "greedy":
        method = "temperature"  # identical greedy samples would be no demo
    sampling = SamplingConfig(method=method, temperature=args.temperature)
    eng = GenerationEngine(
        net, batch_size=args.batch_size, max_length=args.max_length,
        prefill_buckets=(16, 32, 64), eos_id=None, pad_id=0,
        sampling=sampling, paged=paged, page_size=args.page_size,
        num_pages=args.num_pages, prefix_cache=args.share_prefix,
        draft_net=net if args.speculate else None,
        speculate_k=args.speculate, device=device)
    bat = ContinuousBatcher(eng, device=device)

    rs = np.random.RandomState(1)
    if args.samples > 1:
        # one prompt, N samples: the leader prefills, the rest are
        # copy-on-write forks that share its prompt pages
        leader = bat.submit(list(rs.randint(1, args.vocab, 32)),
                            max_new_tokens=args.max_new_tokens,
                            samples=args.samples)
        reqs = leader.samples
    elif args.share_prefix:
        # same system-prompt head on every request; the first prefill
        # computes it, later ones adopt the cached pages
        head = list(rs.randint(1, args.vocab, 32))
        reqs = [bat.submit(head + list(rs.randint(1, args.vocab,
                                                  rs.randint(4, 16))),
                           max_new_tokens=args.max_new_tokens)
                for _ in range(args.requests)]
    else:
        reqs = [bat.submit(list(rs.randint(1, args.vocab, rs.randint(4, 48))),
                           max_new_tokens=args.max_new_tokens)
                for _ in range(args.requests)]
    peak_pages = 0
    while bat.step():
        peak_pages = max(peak_pages, eng.pages_in_use)

    result = {"requests": [], "paged": paged}
    for r in reqs:
        toks = r.result()
        tag = "  (forked)" if r.forked else ""
        print(f"req {r.id}: prompt={len(r.prompt):3d} tok  "
              f"ttft={1e3 * r.ttft:7.1f} ms  generated={len(toks):3d}  "
              f"[{', '.join(map(str, toks[:8]))}"
              f"{', ...' if len(toks) > 8 else ''}]{tag}")
        result["requests"].append(dict(id=r.id, prompt=list(r.prompt),
                                       tokens=list(toks), ttft=r.ttft,
                                       forked=bool(r.forked)))
    programs = REGISTRY.get("gen_recompiles_total")
    kind = ("prefill buckets used + 1 draft + 1 verify" if eng.speculative
            else "prefill buckets used + 1 decode")
    result["programs"] = eng.compiled_programs
    print(f"\ncompiled programs: {eng.compiled_programs} ({kind}) — "
          f"{int(programs.total()) if programs else 0} counted by telemetry")
    if paged:
        result["pages"] = dict(peak=peak_pages, pool=eng.num_pages,
                               page_size=eng.page_size,
                               held=eng.pages_in_use)
        print(f"pages: peak {peak_pages}/{eng.num_pages} in use "
              f"(page_size {eng.page_size}, now {eng.pages_in_use} held)")
    if args.share_prefix or args.samples > 1:
        hits, hit_toks = (_total("gen_prefix_hits_total"),
                          _total("gen_prefix_hit_tokens"))
        prefills = len([r for r in reqs if not r.forked and r.done])
        result["prefix"] = dict(hits=hits, prefills=prefills,
                                hit_tokens=hit_toks,
                                cow_copies=_total("gen_cow_copies_total"),
                                forks=_total("gen_forks_total"))
        print(f"prefix sharing: {hits}/{prefills} prefill(s) hit the radix "
              f"cache ({hit_toks} prompt tokens adopted, zero recompute), "
              f"{_total('gen_cow_copies_total')} CoW page copies, "
              f"{_total('gen_forks_total')} forks")
    if eng.speculative:
        rate = REGISTRY.get("gen_spec_accept_rate")
        acc = REGISTRY.get("gen_spec_accepted_tokens_total")
        drf = REGISTRY.get("gen_spec_drafted_tokens_total")
        overall = (acc.total() / drf.total()) if acc and drf else float("nan")
        last = rate.value() if rate is not None else float("nan")
        result["accept_rate"] = overall
        print(f"speculative k={eng.speculate_k}: accept rate "
              f"{overall:.2f} overall ({last:.2f} last round)")
    return result


if __name__ == "__main__":
    main()
