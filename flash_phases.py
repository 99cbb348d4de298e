#!/usr/bin/env python3
"""Per-warp phase times of one of flash attention's bodies, from a copy of
its source that stamps clock64().

    python3 flash_phases.py [--src DIR] [--label NAME]
        [--body mma|pair|wide|fma|fma_wide]
        [--case D[,DTYPE[,HKV,S[,WINDOW]]] ...]

Copies DIR (a tree's `src/`, this tree's by default) to
`build/flash_phases/NAME-BODY/src`, edits the copy's `flash_attention.cu`
(each edit's text must be in it exactly once, as a mutant's of
chip_smoke.py: it adds a `__device__` array, an `extern "C"` reader and
clock64() stamps in one kernel: `flash_mma_kernel`, the body of 16-bit rows
at Dp 16 and 32, by default; `--body pair`, `flash_wgmma_pair_kernel`,
16-bit rows above 256 columns, phases PAIR_PHASES; `--body wide`, the
chunked wide body of a tree from before the pair body, phases WIDE_PHASES;
`--body fma`, `flash_fma_kernel`, float32 at every head size up to 256,
phases FMA_PHASES; `--body fma_wide`, the same kernel's clusters above
256 columns, float32 and the rows the fma body takes there, phases
FMA_WIDE_PHASES), builds that source alone, and runs causal flash
attention at qwen2.5-3b's prefill layout (B = 4, Hq = 16, Hkv = 2, S =
1000), or at the case's KV heads, S and window (`256,float32,1,4096,2048`
is recurrentgemma-9b's), at each case's head size and type (by default D
8, 16 and 32 in bf16). For each case it
prints, over the warps of all blocks, the mean and the largest cycles a
warp spent on (the mma body's phases):

  start    the Q tile's load and its fragments, up to the first K/V issue;
  issue    issuing a K/V tile's cp.async copies;
  wait     the wait for a K/V tile (cp.async.wait_group and the barrier);
  qk       Q K^T on mma.sync;
  mask     the mask and the scale (the parent: with the per-element max);
  max      the row max's shuffles and the new max;
  exp      the exponentials and row sums (and alpha);
  rescale  the rescale of acc;
  pv       P V with its ldmatrix;
  close    the closing barrier of a tile (none where the ring has one
           barrier a tile);
  end      the row sums' shuffles and the stores;

the tiles a warp took, its whole time, and, from %globaltimer, the span of
the launch (first warp's start to last warp's end) beside the longest
warp's and the kernel time by CUDA events of the stamped copy (the stamps
cost a little). A stamp marks where a warp issued its instructions, not
where their results landed: a product's latency shows in the phase that
first reads it. Warps of other blocks on the same SM interleave, so a
phase's cycles include theirs: compare shares, and two trees in one call.
One JSON line at the end, then the card's name and power limit. Needs one
NVIDIA card. The copy, its build and its reader: `phases_common.py`.
"""
from __future__ import annotations

import os
import sys

import torch

import phases_common as pc

SYMBOL = "repro_flash_phase"
PHASES = ("start", "issue", "wait", "qk", "mask", "max", "exp", "rescale",
          "pv", "close", "end")
# stamps a warp: PHASES, then tiles, the whole time, %globaltimer at its
# start and end (ns), and the SM it ran on
NSLOT = 16
TILES, TOTAL, T0, T1, SMID = range(len(PHASES), len(PHASES) + 5)
MAXW = 1 << 17                     # warps recorded (98304 in the fma body at D2048)
(START, ISSUE, WAIT, QK, MASK, MAX, EXP, RESCALE, PV, CLOSE,
 END) = range(len(PHASES))

RECORD = (
    f"  ph_tick({END});\n"
    f"  ph_[{TOTAL}] = clock64() - ph_start;\n"
    "  {\n"
    "    unsigned long long g1;\n"
    "    unsigned sm;\n"
    '    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));\n'
    '    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));\n'
    f"    ph_[{T0}] = ph_g0;\n"
    f"    ph_[{T1}] = g1;\n"
    f"    ph_[{SMID}] = sm;\n"
    "  }\n"
    "  {\n"
    "    const long long wid = ((long long)(blockIdx.z * gridDim.y +\n"
    "                                       blockIdx.y) * gridDim.x +\n"
    "                           blockIdx.x) * (blockDim.x / 32) +\n"
    "                          threadIdx.x / 32;\n"
    f"    if ((threadIdx.x & 31) == 0 && wid < {MAXW})\n"
    f"      for (int i = 0; i < {NSLOT}; ++i)\n"
    "        " + SYMBOL + "[wid][i] = ph_[i];\n"
    "  }\n")

# csrc/flash_attention.cu's edits (`phases_common.Edit`)
EDITS = (
    # the stamps' state, at the mma body's start
    (("  uint32_t* Qs = smem + (SLOTS - 1) * 2 * TILE;   "
      "// the last slot's K area\n",
      "  uint32_t* Qs = smem + (MMA_SLOTS - 1) * 2 * TILE;   "
      "// the last slot's K\n"),
     lambda old: old +
     f"  unsigned long long ph_[{NSLOT}] = {{}};\n"
     "  const unsigned long long ph_start = clock64();\n"
     "  unsigned long long ph_t = ph_start, ph_g0;\n"
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ph_g0));\n'
     "  auto ph_tick = [&](int i) {\n"
     "    const unsigned long long now = clock64();\n"
     "    ph_[i] += now - ph_t;\n"
     "    ph_t = now;\n"
     "  };\n"),
    # the end of the start: the parent's first issue, after Q's fragments;
    # the change issues Q and its first tiles together, then the fragments
    (("  issue(kt_lo);\n",
      "  // rows r0 = g and r1 = g + 8 of the warp's 16, from rw = its first;"
      " m in\n"),
     lambda old: f"  ph_tick({START});\n" + old + (
         f"  ph_tick({ISSUE});\n" if "issue" in old else "")),
    (("      issue(kt + 1);\n",
      "    issue(kt + MMA_SLOTS - 1);          "
      "// into the slot kt - 1 was read from\n"),
     lambda old: old + old[:len(old) - len(old.lstrip())]
     + f"ph_tick({ISSUE});\n"),
    (("    __syncthreads();\n"
      "    const uint32_t* Ks = smem + ((kt - kt_lo) % SLOTS) * 2 * TILE;\n",
      "    __syncthreads();    // tile kt landed for all; kt - 1 is read\n"),
     lambda old: old + f"    ph_tick({WAIT});\n    ph_[{TILES}]++;\n"),
    (("    // mask and online softmax on the fragment",
      "    // mask only where the tile straddles S, the diagonal or the "
      "window\n    // edge for the warp's rows"),
     lambda old: old[:len(old) - len(old.lstrip())] + f"ph_tick({QK});\n"
     + old),
    (("      tmax1 = fmaxf(tmax1, fmaxf(s[n][2], s[n][3]));\n    }\n",
      "    // the row max on the raw logits (the scale is positive); a row's"
      " 64\n"),
     lambda old: (old + f"    ph_tick({MASK});\n") if old.startswith(
         "      tmax1") else f"      ph_tick({MASK});\n" + old),
    (("    const float mn0 = fmaxf(m0, tmax0), mn1 = fmaxf(m1, tmax1);\n",
      "    // the running max and the old terms' factor alpha, in log2 "
      "units\n"),
     lambda old: old[:len(old) - len(old.lstrip())] + f"ph_tick({MAX});\n"
     + old),
    (("#pragma unroll\n    for (int d = 0; d < DB; ++d) {\n"
      "      acc[d][0] *= alpha0;\n",
      "#pragma unroll\n      for (int d = 0; d < DB; ++d) {\n"
      "        acc[d][0] *= alpha0;\n"),
     lambda old: f"ph_tick({EXP});\n" + old),
    (("    // acc += P V: the logit fragments of key blocks 2kk, 2kk+1 are "
      "the A\n    // fragment of k-step kk\n",
      "    // acc += P V: the logit fragments"),
     lambda old: old[:len(old) - len(old.lstrip())] + f"ph_tick({RESCALE});\n"
     + old),
    (("    __syncthreads();              "
      "// this slot is free for the tile after next\n",
      "    // P V done: the next tile's barrier frees this slot\n"),
     lambda old: f"    ph_tick({PV});\n" + old + f"    ph_tick({CLOSE});\n"),
    ("  }\n}\n\n// -------------------------------------------------------"
     "--------------------\n// bfloat16 at D = 64 / 128 / 256 on wgmma",
     "  }\n" + RECORD + "}\n\n// ---------------------------------------"
     "------------------------------------\n// bfloat16 at D = 64 / 128 / "
     "256 on wgmma"),
)


# `--body wide`: flash_wgmma_wide_kernel (16-bit rows above 256 columns, a
# block of one consumer warpgroup a 256-column chunk), a consumer warp's
# cycles on the start (up to its first wait for a Q / K piece), the waits
# for the Q / K pieces, Q K^T on wgmma, the wait for the V chunk, the
# softmax (mask, max, exponentials, rescale), P V, the turns between them
# and the end (the row sums and the stores)
WIDE_PHASES = ("start", "qk_wait", "qk", "v_wait", "softmax", "pv", "rest",
               "end")
(W_START, W_QK_WAIT, W_QK, W_V_WAIT, W_SOFTMAX, W_PV, W_REST,
 W_END) = range(len(WIDE_PHASES))
W_RECORD = RECORD.replace(f"ph_tick({END})", f"ph_tick({W_END})")
WIDE_EDITS = (
    ("  unsigned char* Vs = QK + SQ * W::QK_STAGE;      "
     "// stage s: 4 V boxes\n",
     lambda old: old +
     f"  unsigned long long ph_[{NSLOT}] = {{}};\n"
     "  const unsigned long long ph_start = clock64();\n"
     "  unsigned long long ph_t = ph_start, ph_g0;\n"
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ph_g0));\n'
     "  auto ph_tick = [&](int i) {\n"
     "    const unsigned long long now = clock64();\n"
     "    ph_[i] += now - ph_t;\n"
     "    ph_t = now;\n"
     "  };\n"),
    ("  int n = 0;                                      "
     "// (Q, K) pieces taken\n",
     lambda old: old + f"  ph_tick({W_START});\n"),
    ("      mbar_wait(&qk_full[s], (n / SQ) & 1);       // getfin\n",
     lambda old: f"      ph_tick({W_REST});\n" + old
     + f"      ph_tick({W_QK_WAIT});\n"),
    ("      __syncwarp();\n"
     "      if (lane == 0) mbar_arrive(&qk_empty[s]);   "
     "// this warp is done with s\n",
     lambda old: f"      ph_tick({W_QK});\n" + old),
    ("    mbar_wait(&v_full[sv], (i / SV) & 1);\n",
     lambda old: f"    ph_tick({W_REST});\n" + old
     + f"    ph_tick({W_V_WAIT});\n    ph_[{TILES}]++;\n"),
    ("      // O += P V over this block's columns",
     lambda old: f"      ph_tick({W_SOFTMAX});\n" + old),
    ("      fence_regs(oacc);\n    }\n    __syncwarp();\n"
     "    if (lane == 0) mbar_arrive(&v_empty[sv]);\n",
     lambda old: old.replace("    }\n", f"      ph_tick({W_PV});\n    }}\n",
                             1)),
    ("  }\n}\n\n// The tensor map of a [B, H, S, D] operand",
     lambda old: "  }\n" + W_RECORD + old[len("  }\n"):]),
)

# `--body pair`: flash_wgmma_pair_kernel (16-bit rows at 256 < D <= 512, two
# consumer warpgroups of 256 columns that add their parts of Q K^T), a
# consumer warp's cycles on the start (Q's wait included), the wait for its
# warpgroup's K half, its part of Q K^T on wgmma, the exchange of the
# partial S (the stores, both barriers, the adds), the softmax, the wait
# for the V half, P V, the turns between them and the end
PAIR_PHASES = ("start", "k_wait", "qk", "exchange", "softmax", "v_wait", "pv",
               "rest", "end")
(P_START, P_K_WAIT, P_QK, P_XCH, P_SOFTMAX, P_V_WAIT, P_PV, P_REST,
 P_END) = range(len(PAIR_PHASES))
PAIR_EDITS = (
    ("  float4* xch = reinterpret_cast<float4*>(Vs + 2 * P::HALF);\n",
     lambda old: old + WIDE_EDITS[0][1]("")),
    ("  if constexpr (!STREAM) mbar_wait(&q_full, 0);\n",
     lambda old: old + f"  ph_tick({P_START});\n"),
    ("          mbar_wait(&k_full[w][s], (nq / SQ) & 1);  // getfin\n",
     lambda old: f"          ph_tick({P_REST});\n" + old
     + f"          ph_tick({P_K_WAIT});\n"),
    ("          wgmma_wait<1>();\n          if (j > 0) release((nq - 1) % SQ);\n",
     lambda old: old + f"          ph_tick({P_QK});\n"),
    ("        wgmma_wait<0>();\n        fence_regs(sacc);\n"
     "        release((nq - 1) % SQ);\n",
     lambda old: old + f"        ph_tick({P_QK});\n"),
    ("      mbar_wait(&k_full[w][0], i & 1);            // getfin\n",
     lambda old: f"      ph_tick({P_REST});\n" + old
     + f"      ph_tick({P_K_WAIT});\n"),
    ("      release(0);                                 // K's slot is free\n",
     lambda old: f"      ph_tick({P_QK});\n" + old),
    ('      asm volatile("bar.sync 2, %0;\\n" ::"n"(2 * 128) : "memory");\n',
     lambda old: old + f"      ph_tick({P_XCH});\n"),
    ("      mbar_wait(&v_full[w], i & 1);\n      fence_regs(oacc);\n",
     lambda old: f"      ph_tick({P_SOFTMAX});\n      ph_[{TILES}]++;\n"
     "      mbar_wait(&v_full[w], i & 1);\n"
     f"      ph_tick({P_V_WAIT});\n      fence_regs(oacc);\n"),
    ("      fence_regs(oacc);\n    } else {\n",
     lambda old: f"      fence_regs(oacc);\n      ph_tick({P_PV});\n"
     "    } else {\n"),
    ("  }\n}\n\n// The tensor map of a [B, H, S, D] operand",
     lambda old: "  }\n" + RECORD.replace(f"ph_tick({END})",
                                          f"ph_tick({P_END})")
     + old[len("  }\n"):]),
)
# `--body fma`: flash_fma_kernel (float32, integers and mixed types on
# float32 copies, and 16-bit / fp8 rows at Dp 16 and 32), a consumer warp's
# cycles on the start (the Q tile's load, up to the first K/V tile), the
# K/V tiles' loads or its waits for them (the load and its barriers in a
# body that loads them between barriers), Q K^T, the softmax (the mask,
# the max, the exponentials, P into shared memory, alpha, and the barriers
# around them), P V (with the rescale) and the end (the row sums and the
# stores)
FMA_PHASES = ("start", "load", "qk", "softmax", "pv", "end")
F_START, F_LOAD, F_QK, F_SOFTMAX, F_PV, F_END = range(len(FMA_PHASES))
FMA_EDITS = (
    (("  float* Ps = Vs + BN * WS;\n",
      "  float* lsum_s = alpha_s + BMF;                  "
      "// a row's sum at the end\n"),
     lambda old: old + WIDE_EDITS[0][1]("")),
    (("  load_tile_f32<E, D, BM, EXACT>(Qs, qb, q_ss, q0, S, dh);\n",
      "  mbar_wait(q_full, 0);\n"),
     lambda old: old + f"  ph_tick({F_START});\n"),
    (("    load_tile_f32<E, D, BN, EXACT>(Vs, vb, v_ss, k0, S, dh);\n"
      "    __syncthreads();\n",
      "    mbar_wait(&full[sk], (uint32_t)((it / SLOTS) & 1));     "
      "// getfin: K\n",
      "      mbar_wait(&full[sk], (uint32_t)((it / SLOTS) & 1));     "
      "// getfin: K\n"),
     lambda old: old + f"    ph_tick({F_LOAD});\n    ph_[{TILES}]++;\n"),
    (("    // mask, online softmax; P goes to shared memory for the second "
      "product.\n",
      "    // every consumer is past the last tile's P V: P^T and alpha are "
      "free\n"),
     lambda old: f"    ph_tick({F_QK});\n" + old),
    (("    // acc += P V: rows ty*4+i, output columns tx+16*jj\n",
      "    // acc = acc alpha + P V: 8 rows of P^T and 8 columns of V a key, "
      "4\n"),
     lambda old: f"    ph_tick({F_SOFTMAX});\n" + old),
    # (the ring's body only: the wait for V, the rescale before it in P V)
    (("      float p[RPT];\n",
      "    mbar_wait(&full[sv], (uint32_t)(((it + 1) / SLOTS) & 1));   "
      "// getfin: V\n",
      "      mbar_wait(&full[sv], (uint32_t)((it / SLOTS) & 1));     "
      "// getfin: V\n"),
     lambda old: old if "RPT" in old else
     f"    ph_tick({F_PV});\n" + old + f"    ph_tick({F_LOAD});\n"),
    (("  }\n\n  E* ob = o + b * o_sb + h * o_sh;\n",
      "    if (lane == 0) mbar_arrive(&empty[sv]);       "
      "// V's slot is free\n"),
     lambda old: f"    ph_tick({F_PV});\n" + old if "E* ob" in old
     else old + f"    ph_tick({F_PV});\n"),
    (("  }\n}\n\n// -----------------------------------------------------------"
      "----------------\n// The fma body above 256 columns",
      "          ob[r * o_ss + col(c)] = from_float<E>(acc[i][c] * inv);\n"
      "    }\n  }\n}\n",
      "  if constexpr (WIDE) hopper::cluster_wait();\n}\n"),
     lambda old: ("  }\n" + RECORD.replace(f"ph_tick({END})",
                                           f"ph_tick({F_END})")
                  + old[len("  }\n"):]) if old.startswith("  }\n}")
     else old[:-2] + RECORD.replace(f"ph_tick({END})", f"ph_tick({F_END})")
     + "}\n"),
)
# `--body fma_wide`: the fma body's clusters above 256 columns (a CTA a
# 256-column piece of the head), a consumer warp's cycles on the start (Q's
# load), the waits for the ring's items (a later piece's Q, K, V), its
# partial Q K^T (with the fold of the partial tiles), the exchange (its
# partials written, the arrivals on every CTA's barrier, the wait for the
# cluster's, the peers' partials read and summed), the softmax (with the
# rescale of acc), P V and the end (the row sums, the stores and the last
# cluster barrier); a tile is an exchange
FMA_WIDE_PHASES = ("start", "wait", "qk", "exchange", "softmax", "pv", "end")
(X_START, X_WAIT, X_QK, X_XCH, X_SOFTMAX, X_PV,
 X_END) = range(len(FMA_WIDE_PHASES))
FMA_WIDE_EDITS = (
    ("  float* lsum_s = alpha_s + BMF;                  "
     "// a row's sum at the end\n", FMA_EDITS[0][1]),
    ("  mbar_wait(q_full, 0);\n",
     lambda old: old + f"  ph_tick({X_START});\n"),
    ("        mbar_wait(&full[s0], (uint32_t)((it / SLOTS) & 1));\n"
     "        mbar_wait(&full[s1], (uint32_t)(((it + 1) / SLOTS) & 1));\n",
     lambda old: f"        ph_tick({X_QK});\n" + old
     + f"        ph_tick({X_WAIT});\n"),
    ("      mbar_wait(&full[sk], (uint32_t)((it / SLOTS) & 1));     "
     "// getfin: K\n",
     lambda old: f"      ph_tick({X_QK});\n" + old
     + f"      ph_tick({X_WAIT});\n"),
    ("      fold_rows<1, 2>(s, lane);\n    }\n  };\n",
     lambda old: old[:-len("  };\n")] + f"    ph_tick({X_QK});\n  }};\n"),
    ("      sum_partials(s, buf(j), ncta);\n",
     lambda old: old + f"      ph_tick({X_XCH});\n      ph_[{TILES}]++;\n"),
    ("    if (lane < ncta) hopper::mbar_arrive_cluster(&xfull[j & 1], lane);\n",
     lambda old: old + f"    ph_tick({X_XCH});\n"),
    ("      mbar_wait(&full[sv], (uint32_t)((it / SLOTS) & 1));     "
     "// getfin: V\n",
     lambda old: f"      ph_tick({X_SOFTMAX});\n" + old
     + f"      ph_tick({X_WAIT});\n"),
    ("      if (lane == 0) mbar_arrive(&empty[sv]);       "
     "// V's slot is free\n",
     lambda old: old + f"      ph_tick({X_PV});\n"),
    ("  if constexpr (WIDE) hopper::cluster_wait();\n}\n",
     lambda old: old[:-2] + RECORD.replace(f"ph_tick({END})",
                                           f"ph_tick({X_END})") + "}\n"),
)
BODIES = {"mma": (PHASES, EDITS), "wide": (WIDE_PHASES, WIDE_EDITS),
          "pair": (PAIR_PHASES, PAIR_EDITS), "fma": (FMA_PHASES, FMA_EDITS),
          "fma_wide": (FMA_WIDE_PHASES, FMA_WIDE_EDITS)}


def main() -> int:
    args = pc.parse_args(__doc__, "flash_phases", ["8", "16", "32"],
                         tuple(BODIES))
    if args is None:
        return 1
    import chip_smoke as cs
    phases, edits = BODIES[args.body]
    copy = pc.make_copy(os.path.abspath(args.src), "flash_phases",
                        f"{args.label}-{args.body}", "flash_attention.cu",
                        edits, SYMBOL, MAXW, NSLOT)
    lib, build = pc.build(copy, "flash_attention", SYMBOL, args.label)
    from repro_torch.kernels import flash_attention as fa
    if args.build_only:
        return 0
    hz = pc.sm_hz()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, hq = cs.BATCH, 16
    results = []
    for case in args.case:
        d, *rest = case.split(",")
        d = int(d)
        dtype = getattr(torch, rest[0]) if rest else torch.bfloat16
        # the layout: qwen2.5-3b's prefill, or KV heads, S and a window
        hkv, s, window = (int(rest[1]), int(rest[2]),
                          int(rest[3]) if len(rest) > 3 else 0) \
            if len(rest) > 2 else (2, cs.PROMPT_LEN, 0)
        body = fa.body_for(dtype, d)
        if body == "wgmma" and d > fa.CHUNK_DIM:    # the parent's: chunks
            body = "pair" if hasattr(fa, "wide_blocks") else "wide"
        if body == "fma" and d > fa.CHUNK_DIM:
            body = "fma_wide"
        if body != args.body:
            raise ValueError(f"flash_phases: D{d} {dtype} runs the {body} "
                             f"body, not the {args.body} body")
        q, k, v = cs.flash_case(gen, b, hq, hkv, s, d, dtype)
        cs.check_flash_out(f"flash D{d} {cs.tname(dtype)} (stamped copy)",
                           fa.flash_attention(q, k, v, window=window), q, k,
                           v, window=window)
        ms = cs.time_ms([lambda: fa.flash_attention(q, k, v, window=window)],
                        20)
        stamps = pc.stamps(lib, build, SYMBOL, MAXW, NSLOT,
                           lambda: fa.flash_attention(q, k, v, window=window))
        warps = stamps[stamps[:, TOTAL] > 0]
        total = warps[:, TOTAL]
        t0, t1 = warps[:, T0], warps[:, T1]
        row = dict(case=f"B{b} Hq{hq} Hkv{hkv} S{s} D{d} {cs.tname(dtype)} "
                        "causal" + (f" window{window}" if window else ""),
                   kernel_ms=ms, sm_mhz=hz / 1e6, warps=int(warps.shape[0]),
                   tiles_mean=float(warps[:, TILES].mean()),
                   tiles_max=float(warps[:, TILES].max()),
                   total_cycles_mean=float(total.mean()),
                   total_cycles_max=float(total.max()),
                   total_us_max=float(total.max()) / hz * 1e6,
                   span_us=float(t1.max() - t0.min()) / 1e3,
                   last_start_us=float(t0.max() - t0.min()) / 1e3,
                   sms=int(torch.unique(warps[:, SMID]).numel()))
        tiles = warps[:, TILES].clamp(min=1)
        for i, name in enumerate(phases):
            row[f"{name}_cycles_mean"] = float(warps[:, i].mean())
            row[f"{name}_cycles_max"] = float(warps[:, i].max())
            row[f"{name}_share"] = float(warps[:, i].sum() / total.sum())
            row[f"{name}_cycles_a_tile"] = float((warps[:, i] / tiles).mean())
        results.append(row)
        print(f"{args.label}: flash {row['case']} ({args.body} body): "
              f"{ms:.4f} ms "
              f"stamped, launch span {row['span_us']:.2f} us (last warp "
              f"started at {row['last_start_us']:.2f} us, {row['sms']} SMs),"
              f" a warp {row['tiles_mean']:.2f} tiles (max "
              f"{row['tiles_max']:.0f}), {row['total_cycles_mean']:.0f} "
              f"cycles (max {row['total_us_max']:.2f} us at "
              f"{hz / 1e6:.0f} MHz); shares "
              + ", ".join(f"{n} {row[f'{n}_share']:.3f} (mean "
                          f"{row[f'{n}_cycles_mean']:.0f}, "
                          f"{row[f'{n}_cycles_a_tile']:.0f} a tile)"
                          for n in phases),
              flush=True)
        del q, k, v
    pc.close(args.label, args.src, results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
