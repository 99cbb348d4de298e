#!/usr/bin/env python3
"""Per-block phase times of the paged attention kernel, from a copy of its
source that stamps clock64().

    python3 paged_phases.py [--src DIR] [--label NAME] [--body ring|wide]
        [--case HKV,D[,T[,DTYPE]] ...]

Copies DIR (a tree's `src/`, this tree's by default) to
`build/paged_phases/NAME/src`, edits the copy's `paged_attention.cu` (each
edit's text must be in it exactly once, as a mutant's of chip_smoke.py: it
adds a `__device__` array, an `extern "C"` reader and clock64() stamps in
each consumer thread), builds that source alone, and runs paged
attention at B = 4, Hq = 16 for each case (KV heads, head size, T, 1032
where not given, and the type of q and the caches, a torch dtype's name,
bfloat16 where not given: `2,8,1032,float8_e4m3fn` is the element body
over e4m3 caches at D = 8; lengths [T, T - 31, (T + 2) // 2, 64]: [1032, 1001, 517,
64] at qwen2.5-3b's decode, [4128, 4097, 2065, 64] at recurrentgemma-9b's
`1,256,4128`; by default 16 heads at D 64, 80 and 128, and qwen2.5-3b's 2
heads at D 128). For each case it prints, over the consumer
sets of all blocks (two sets a block; every chunk's blocks of the wide
body above 256 columns, whose grid has a second dimension), the mean and
the largest cycles spent: waiting for a chunk to land (getfin), Q K^T on the tensor cores with
the logits' exchange, the softmax and P V (and Q K^T on FMAs), the rest (the
loop's turns between chunks), finishing segments (the partials, the ticket,
the last block's merge), the start (the lengths' prefix sums, the barrier,
the empty segments) and a new segment (the split's search, its queries);
chunks and segments a set; the set's whole time; when its first and last
chunk had landed (the end of their getfin); the block's time in microseconds
at the SM clock measured by a sleep kernel; and the copy's kernel time by
CUDA events (the stamps cost a little). One JSON line at the end, then the
card's name and power limit. `--body wide` stamps the wide body above 256
columns on FMAs instead (`paged_wide_kernel`, in a tree that has it: warp 0
of each of a block's two parities, phases WIDE_PHASES, the chunk counts
and the first and last getfin in the same slots), under
`build/paged_phases/NAME-wide/`. Needs one NVIDIA card. The copy, its
build and its reader: `phases_common.py`.
"""
from __future__ import annotations

import os
import sys

import torch

import phases_common as pc

SYMBOL = "repro_paged_phase"
ROWS = 2048                        # consumer sets recorded: 2 a block
PHASES = ("wait", "qk", "softmax_pv", "rest", "finish", "start", "segment")
# stamps a consumer set: PHASES, then chunks, segments, the whole time, and
# the times from the start to the end of the first and of the last getfin
SLOTS = 12
CHUNKS, SEGMENTS, TOTAL, FIRST, LAST = range(len(PHASES), SLOTS)

# csrc/paged_attention.cu's edits (`phases_common.Edit`)
EDITS = (
    ("  extern __shared__ __align__(1024) unsigned char smem[];\n",
     "  extern __shared__ __align__(1024) unsigned char smem[];\n"
     f"  unsigned long long ph_[{SLOTS}] = {{}};\n"
     "  const unsigned long long ph_start = clock64();\n"
     "  unsigned long long ph_t = ph_start;\n"
     "  auto ph_tick = [&](int i) {\n"
     "    const unsigned long long now = clock64();\n"
     "    ph_[i] += now - ph_t;\n"
     "    ph_t = now;\n"
     "  };\n"),
    (("  const long long W = P[a.B] * hg;",
      "  // aload of chunk j (the rows from global row g) into slot j % slots;"
      "\n"),
     lambda old: "  ph_tick(5);\n" + old),
    ("        cacc[nt][0] = cacc[nt][1] = cacc[nt][2] = cacc[nt][3] = 0.f;\n"
     "    }\n"
     "    g += n;\n",
     "        cacc[nt][0] = cacc[nt][1] = cacc[nt][2] = cacc[nt][3] = 0.f;\n"
     "    }\n"
     "    ph_tick(6);\n"
     "    g += n;\n"),
    ("      if (cur >= 0) finish();\n",
     "      if (cur >= 0) {\n"
     "        ph_tick(3);\n"
     "        finish();\n"
     "        ph_tick(4);\n"
     f"        ph_[{SEGMENTS}]++;\n"
     "      }\n"),
    ("    mbar_wait(&full[j % a.slots], (uint32_t)((j / a.slots) & 1));  "
     "// getfin\n",
     "    ph_tick(3);\n"
     "    mbar_wait(&full[j % a.slots], (uint32_t)((j / a.slots) & 1));  "
     "// getfin\n"
     "    ph_tick(0);\n"
     f"    if (ph_[{CHUNKS}]++ == 0) ph_[{FIRST}] = ph_t - ph_start;\n"
     f"    ph_[{LAST}] = ph_t - ph_start;\n"),
    (("      set_sync(set);\n"
      "      if (lane < n) sc = lg[hw * 32 + lane] * a.scale;\n"
      "    }\n",
      "      set_sync(set);\n"
      "#pragma unroll\n"
      "      for (int x = 0; x < HX; ++x)\n"
      "        if (lane < n) sc[x] = lg[(hw + GC * x) * 32 + lane] * a.scale;\n"
      "    }\n"),
     lambda old: old + "    ph_tick(1);\n"),
    ("    __syncwarp();\n"
     "    if (lane == 0) mbar_arrive(&empty[j % a.slots]);  "
     "// this warp is past it\n",
     "    ph_tick(2);\n"
     "    __syncwarp();\n"
     "    if (lane == 0) mbar_arrive(&empty[j % a.slots]);  "
     "// this warp is past it\n"),
    ("  finish();\n}\n\n// The tensor map",
     "  ph_tick(3);\n"
     "  finish();\n"
     "  ph_tick(4);\n"
     f"  ph_[{SEGMENTS}]++;\n"
     f"  ph_[{TOTAL}] = clock64() - ph_start;\n"
     "  const unsigned ph_b = blockIdx.y * gridDim.x + blockIdx.x;\n"
     f"  if (lane == 0 && hw == 0 && ph_b < {ROWS // 2}) {{\n"
     f"    for (int i = 0; i < {SLOTS}; ++i)\n"
     "      " + SYMBOL + "[ph_b * 2 + set][i] = ph_[i];\n"
     "  }\n"
     "}\n\n// The tensor map"),
)
# `--body wide`: the wide body above 256 columns on FMAs
# (`paged_wide_kernel`, in a tree that has it), warp 0 of each parity a
# block: the waits for its K and V pieces (getfin), Q K^T with q's loads
# and the transpose reductions, the exchange of the parities' parts (its
# barrier), the softmax, P V, finishing segments (the partials, the
# tickets, the merges) and the start (the prefix sums, the barrier, the
# empty segments), in the same slots
WIDE_PHASES = ("wait", "qk", "exchange", "softmax", "pv", "finish", "start")
(W_WAIT, W_QK, W_XCH, W_SOFTMAX, W_PV, W_FINISH,
 W_START) = range(len(WIDE_PHASES))
W_SETUP = W_START      # a new segment's set-up counts as the start
WIDE_EDITS = (
    ("  float* accs = reinterpret_cast<float*>(wsmem + L.acc);\n",
     lambda old: old + EDITS[0][1].split("\n", 1)[1]),
    ("  if (warp == NSET * GC) {\n    // the producer: for each chunk of rows "
     "of the share, all its K pieces,\n",
     lambda old: f"  ph_tick({W_START});\n" + old),
    ("      if (cur != -1) finish();\n",
     "      if (cur != -1) {\n"
     f"        ph_tick({W_PV});\n"
     "        finish();\n"
     f"        ph_tick({W_FINISH});\n"
     f"        ph_[{SEGMENTS}]++;\n"
     "      }\n"),
    ("      const int i = it + pc, slot = i % a.slots;\n"
     "      mbar_wait(&full[slot], (uint32_t)((i / a.slots) & 1));   "
     "// getfin\n",
     lambda old: f"      ph_tick({W_QK});\n" + old
     + f"      ph_tick({W_WAIT});\n"
     f"      if (ph_[{CHUNKS}] == 0 && pc == half) ph_[{FIRST}] = ph_t - "
     "ph_start;\n"),
    ("    float* xb = xch + (j & 1) * (NSET * GC * 32);\n",
     lambda old: f"    ph_tick({W_QK});\n" + old),
    ("    consumers_sync();\n    float p = 0.f, alpha = 1.f;\n",
     lambda old: old.replace("consumers_sync();\n",
                             f"consumers_sync();\n    ph_tick({W_XCH});\n")),
    ("    // P V over the warp's V pieces: a piece's accumulators rescaled "
     "by\n",
     lambda old: f"    ph_tick({W_SOFTMAX});\n" + old),
    ("      const int i = it + a.npk + pc, slot = i % a.slots;\n"
     "      mbar_wait(&full[slot], (uint32_t)((i / a.slots) & 1));   "
     "// getfin\n",
     lambda old: f"      ph_tick({W_PV});\n" + old
     + f"      ph_tick({W_WAIT});\n      ph_[{LAST}] = ph_t - ph_start;\n"),
    ("    it += a.npk + npb;\n",
     lambda old: f"    ph_tick({W_PV});\n    ph_[{CHUNKS}]++;\n" + old),
    ("  finish();\n}\n\n// The wide body's launch",
     f"  ph_tick({W_PV});\n"
     "  finish();\n"
     f"  ph_tick({W_FINISH});\n"
     f"  ph_[{SEGMENTS}]++;\n"
     f"  ph_[{TOTAL}] = clock64() - ph_start;\n"
     "  const unsigned ph_b = blockIdx.y * gridDim.x + blockIdx.x;\n"
     f"  if (lane == 0 && hw == 0 && ph_b < {ROWS // 2}) {{\n"
     f"    for (int i = 0; i < {SLOTS}; ++i)\n"
     "      " + SYMBOL + "[ph_b * 2 + half][i] = ph_[i];\n"
     "  }\n"
     "}\n\n// The wide body's launch"),
)
BODIES = {"ring": (PHASES, EDITS), "wide": (WIDE_PHASES, WIDE_EDITS)}


def route(pa, x) -> str:
    """The body a call on these tensors runs: `paged_attention.route` in
    a tree that has it, else the rule on (type, head size)."""
    if hasattr(pa, "route"):
        return pa.route(*x)
    return pa.body_for(x[1].dtype, x[0].shape[-1])


def main() -> int:
    args = pc.parse_args(__doc__, "paged_phases",
                         ["16,64", "16,80", "16,128", "2,128"],
                         tuple(BODIES))
    if args is None:
        return 1
    import chip_smoke as cs
    phases, edits = BODIES[args.body]
    label = args.label if args.body == "ring" else f"{args.label}-wide"
    copy = pc.make_copy(os.path.abspath(args.src), "paged_phases",
                        label, "paged_attention.cu", edits, SYMBOL,
                        ROWS, SLOTS)
    lib, build = pc.build(copy, "paged_attention", SYMBOL, args.label)
    from repro_torch.kernels import paged_attention as pa, ref
    if args.build_only:
        return 0
    hz = pc.sm_hz()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, hq = cs.BATCH, 16
    results = []
    for case in args.case:
        hkv, d, *rest = case.split(",")
        hkv, d = int(hkv), int(d)
        t = int(rest[0]) if rest else cs.PROMPT_LEN + cs.MAX_NEW
        dtype = getattr(torch, rest[1]) if len(rest) > 1 else torch.bfloat16
        lens = torch.tensor([t, t - 31, (t + 2) // 2, 64], dtype=torch.int32,
                            device="cuda")
        x = (cs.rand_typed(gen, (b, hq, d), dtype, cs.Q_SCALE),
             cs.rand_typed(gen, (b, t, hkv, d), dtype),
             cs.rand_typed(gen, (b, t, hkv, d), dtype))
        cs.paged_out_check(f"paged Hkv{hkv} D{d} {cs.tname(dtype)} (stamped "
                           "copy)", pa.paged_attention(*x, lens),
                           ref.paged_attention_ref(*x, lens))
        ms = cs.time_ms([lambda: pa.paged_attention(*x, lens)], 64)
        stamps = pc.stamps(lib, build, SYMBOL, ROWS, SLOTS,
                           lambda: pa.paged_attention(*x, lens))
        sets = stamps[stamps[:, TOTAL] > 0]      # sets that had rows
        total = sets[:, TOTAL]
        row = dict(case=f"B{b} Hq{hq} Hkv{hkv} T{t} D{d} {cs.tname(dtype)}",
                   body=route(pa, x),
                   products=pa.products_on(dtype, dtype, d, hq, hkv),
                   kernel_ms=ms, sm_mhz=hz / 1e6, sets=int(sets.shape[0]),
                   chunks_mean=float(sets[:, CHUNKS].mean()),
                   segments_mean=float(sets[:, SEGMENTS].mean()),
                   total_cycles_mean=float(total.mean()),
                   total_cycles_max=float(total.max()),
                   total_us_max=float(total.max()) / hz * 1e6,
                   first_data_cycles_mean=float(sets[:, FIRST].mean()),
                   last_data_cycles_mean=float(sets[:, LAST].mean()),
                   last_data_cycles_max=float(sets[:, LAST].max()))
        for i, name in enumerate(phases):
            row[f"{name}_cycles_mean"] = float(sets[:, i].mean())
            row[f"{name}_cycles_max"] = float(sets[:, i].max())
            row[f"{name}_share"] = float(sets[:, i].sum() / total.sum())
        results.append(row)
        print(f"{args.label}: paged {row['case']} ({row['body']}, "
              f"{row['products']}): {ms:.4f} ms stamped, a set "
              f"{row['chunks_mean']:.2f} chunks, {row['segments_mean']:.2f} "
              f"segments, {row['total_cycles_mean']:.0f} cycles (max "
              f"{row['total_us_max']:.2f} us at {hz / 1e6:.0f} MHz), first "
              f"and last chunk landed at {row['first_data_cycles_mean']:.0f}"
              f" and {row['last_data_cycles_mean']:.0f} cycles (mean); "
              "shares "
              + ", ".join(f"{n} {row[f'{n}_share']:.3f} (mean "
                          f"{row[f'{n}_cycles_mean']:.0f})" for n in phases),
              flush=True)
        del x
    pc.close(args.label, args.src, results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
