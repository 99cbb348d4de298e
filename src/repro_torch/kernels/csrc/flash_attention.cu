// flash_attention: blockwise causal / sliding-window self-attention with GQA.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py. There the KV axis is the innermost,
// sequential grid axis and (m, l, acc) live in scratch across its steps. Here
// one block owns a tile of query rows of one (b, q-head) and loops over the
// KV tiles that causality and the window leave it; (m, l, acc) stay in
// registers for the whole loop and the [S, S] logits never reach device
// memory. Q, K, V and the output are addressed through their strides, so the
// model's [B, S, H, D] layout is read in place, and the ragged edge (S not a
// multiple of the tile) is masked in the kernel: no pad, no transpose copy.
// Blocks with the most KV tiles (the last query tiles) are scheduled first.
//
// Bound on this card: operations. At the serve shape (B = 4, Hq = 16, S =
// 1000, D = 128, bf16, causal) the two products are 16.4 GFLOP against 37 MB
// of Q, K, V and O, some 440 operations a byte, above the H100's ~295
// FLOP/byte ridge. recurrentgemma-9b's (B = 4, Hq = 16, Hkv = 1, S = 4096,
// D = 256, window 2048) is further above it: 412 GFLOP against 285 MB. Only
// wgmma reaches the tensor cores' full rate.
//
// Which body runs is a fixed rule on (type, head size), stated here, in
// `flash_attention_body` below and in the wrapper (`body_for`). float16 runs
// every body bfloat16 runs, the same code with T = __half (`Op16`): the type
// field of mma.sync and wgmma, the rounding of P (`pack2`) and the TMA map's
// data type are all that differ. q, k, v of more than one type never reach
// this file: the wrapper widens them to float32 copies (exact for 16-bit
// types, the reference's own arithmetic) and runs the float32 body.
//
// * float32, any D -> `flash_fma_kernel`: both products as fp32 FMAs on the
//   CUDA cores (TF32 would not hold the fp32 tolerance, atol 2e-5; a split
//   TF32 form on the tensor cores is left for later), bound by the fp32 FMA
//   peak. It also takes integers and mixed types (on float32 copies) and
//   16-bit and fp8 rows at Dp 16 and 32 that TMA cannot load. Its parent
//   (4 x 4 logits a thread, K and V loaded between two barriers a tile)
//   spent a third of a warp's time on the loads and ran its products at
//   ~2 FMAs a shared-memory word, where an SM issues 4 FFMAs for every
//   32-bit word its shared memory delivers (`flash_phases.py --body fma`,
//   PERF.md). So (`FmaRing`):
//   - register tiles: a thread's Q K^T is an 8 x 8 tile of logits (8 query
//     rows, 8 keys KG apart), its 4-column pieces of D read as one LDS.128
//     of Q and one of K a row: 16 LDS.128 for 256 FFMAs, 4 a word. Q, K and
//     V keep their [row][d] layout (rows padded by 8 words, so the 4 key
//     groups and 2 pieces of a quarter-warp hit 8 different 16-byte bank
//     groups); the KSPLIT threads of a tile split D (BM = 128, BN = 64: 2;
//     BM = 64, BN = 64: 4; at D = 256, BM = 64, BN = 32: 8) and fold their
//     partial tiles by shuffles into RS = 8 / KSPLIT rows each for the
//     softmax. P V takes
//     an 8-row x OC-column tile of the output (OC = 8 at D 128 and 256),
//     P stored transposed ([key][row]) so a key's 8 rows are two LDS.128
//     and V's 8 columns two more: 64 FFMAs for 16 words;
//   - loads under the arithmetic: K and V go through a ring of 3 slots (4
//     below, at D = 256 and at 64 rows) filled by a producer warpgroup,
//     the AMI at tile granularity: aload = cp.async of 16-byte pieces for
//     float32 rows of whole pieces (zero-filled past dh and S), whose
//     completion makes each lane's arrival on the slot's full mbarrier;
//     other rows in units of the widest of 8, 4, 2 and 1 bytes that the
//     row, the strides and the starts allow (`fma_load`: 8 for 16-bit rows
//     at D 500, where loads of one element a thread left the consumers
//     waiting 0.40 of a warp's time), widened to fp32 as they are loaded,
//     each lane arriving after its stores. getfin = the consumers' wait on
//     the full barrier; each consumer warp arrives on the slot's empty
//     barrier once it has read it, and the producer refills a slot only
//     after all 8 have. Q goes
//     first, into its own buffer. Two consumer barriers a tile remain
//     (P^T and alpha written, then read);
//   - the tiles left to a block are those of causality and the window
//     (`kt_lo`, `kt_hi`); the query tile is the slowest grid dimension,
//     heaviest first across all heads and batches (the parent's grid took
//     a head's tiles in turn, and its last wave held heavy tiles); the mask
//     only
//     where a tile straddles S, the diagonal or the window edge;
//   - p = 2^(s * scale * log2 e - m), one FFMA and one ex2.approx, m in
//     log2 units (the mma body's NO_KEY rule for a row with no key yet);
//   - one block of 8 consumer warps and the producer warpgroup an SM (209
//     KB of shared memory at D = 128, 212 KB at 256): the registers of the
//     8 x 8 tiles, not the shared memory, bound the warps an SM, and the
//     ring, not a second block, keeps the loads under the arithmetic. A
//     block of 288 or 384 threads is allotted 168 registers a thread, which
//     spilled the tiles (ptxas: 112-392 bytes, at 0.968 ms where the
//     parent took 1.10), so the producers lower theirs to 40 with
//     setmaxnreg and the consumers raise theirs to 232;
//   - query rows a block (`fma_rows`, the wrapper's `fma_rows`): 128 at Dp
//     16 to 128, 64 at 256; but 64 at Dp 64 and 128 where tiles of 128
//     rows would give fewer blocks than the card has SMs (ceil(S / 128) B
//     Hq below the SM count, read from the device: int8 at B2 Hq8 S200 D64
//     ran 32 blocks of 128 rows on 132 SMs, slower than its parent's 4 x 4
//     tiles), twice the blocks, KSPLIT 4 (RS 2, OC = D / 32).
// * bfloat16, D = 64, 128 or 256 -> `flash_wgmma_kernel`, designed for
//   Hopper:
//   - two consumer warpgroups of 64 query rows each (BM = 128) and a
//     producer; one block an SM (161 KB of shared memory at D = 128, 193 KB
//     at D = 256);
//   - the producer is the AMI at tile granularity: aload = TMA
//     (cp.async.bulk.tensor) of the next K and V tiles into a 2-stage ring
//     of shared-memory slots; getfin = the consumers' wait on the stage's
//     *full* mbarrier, which the copies complete by their byte count; a slot
//     is freed when each consumer warp has arrived on the stage's *empty*
//     mbarrier, which the producer waits on before it refills the stage. No
//     consumer thread computes an address or holds a register for a copy;
//   - tensor maps describe the caller's strided [B, H, S, D] views (dims
//     innermost first, the outer three by ascending stride), 128-byte
//     swizzle, boxes of 64 columns. TMA zero-fills rows past S and never
//     reads the next head or batch; logits of keys >= S are still masked (a
//     zero key row gives logit 0, not -inf);
//   - S = Q K^T by wgmma with Q and K both K-major in shared memory; O += P V
//     by wgmma with P from registers (the S accumulator rounded to bf16 in
//     place: its layout is the A fragment's) and V from shared memory as a
//     transposed (MN-major) operand spanning the 64-column boxes, so there
//     is no ldmatrix.trans and no shared-memory traffic per warp beyond what
//     the tensor core reads once for the warpgroup;
//   - masks are applied only on tiles that straddle the diagonal, the window
//     edge or S; a tile masked whole for a warpgroup is skipped (the dead
//     test, per warpgroup: at BM = 128 the two may differ); the first tile
//     loaded is (q0 - window + 1) / BN for the block's first row q0, the
//     last the one of its last row;
//   - the exponentials are the next limit: the SM's special-function unit
//     does 16 ex2 a clock against 1024 bf16 FMAs of the tensor cores, so a
//     128x128 tile's softmax takes about half as long as its two products;
//     each p is one FFMA and one ex2.approx;
//   - the bytes are the third: a 128x128 tile pair at D = 128 reads 64 KB of
//     K and V through the L2 for 8.4 MFLOP, so the tensor cores' rate asks
//     ~7.7 TB/s of the L2 across the card;
//   - the query tile is the slowest grid dimension, heaviest first across
//     all heads and batches, so causal attention's light tiles fill the
//     last wave.
//   Output goes from registers to q's strides.
// * At D = 64 and 128: BN = 128 keys a K/V tile (S = Q K^T by
//   wgmma.m64n128k16, P V by one m64nDk16 a 16-key step) and a producer of
//   one warp, whose one lane issues TMA (288 threads, at most 168 registers
//   a thread). The two consumers overlap each other's softmax unaided:
//   taking turns by named barriers there measured no faster (PERF.md).
// * At D = 256 room bounds the tiles before speed:
//   - at D = 128's tiles a block would need 1 KB + 64 KB of Q + 2 stages x 2
//     x 64 KB of K and V = 321 KB of shared memory, above the 227 KB a block
//     may have; at BN = 64 it needs 1 + 64 + 2 x 2 x 32 = 193 KB;
//   - the O accumulator is D / 2 = 128 fp32 registers a consumer thread,
//     beside 32 of S and 16 of P. A 384-thread block is allotted 168
//     registers a thread, so the producer is a warpgroup that lowers its own
//     to 24 with setmaxnreg and the consumers raise theirs to 240: 128 x 24
//     + 256 x 240 = 384 x 168. One lane of the producer issues the TMA
//     loads; its other warps have nothing to do;
//   - S = Q K^T is 16 wgmma.m64n64k16 a tile; O += P V is one m64n64k16 a
//     64-column V box a 16-key step (four a step), each on its own quarter
//     of the accumulator, so no asm statement names all 128 of them;
//   - two consumers, where one was before: one warpgroup's softmax runs
//     while the other's products keep the tensor cores busy, where with one
//     the tensor cores idled through every softmax. Here too they overlap
//     unaided: taking turns by named barriers (each warpgroup's Q K^T, then
//     its P V, in the order 0, 1, 0, 1) measured slower (PERF.md).
// * bfloat16, D = 16 or 32 -> `flash_mma_kernel` (FlashAttention-2 on
//   mma.sync.m16n8k16, 64 x 64 tiles, 4 warps of 16 query rows, K and V by
//   cp.async). At Dp 16 and 32 the two products are a few mma a tile, so
//   neither the tensor cores nor the bytes bound it but the instructions a
//   warp issues a tile: `flash_phases.py` (clock64 stamps a phase) found
//   them in the exponentials (expf after a separate multiply by the scale),
//   the K/V copies' issue (an index division and a 64-bit address a piece,
//   every tile), the mask (a column index and three tests a logit, on every
//   tile) and two barriers a tile. So:
//   - the mask is applied only where a tile straddles S, the causal
//     diagonal or the window edge for the warp's 16 rows, as the wgmma body
//     does (a tile masked whole for them is computed all the same: its p
//     are 0; skipping it, a branch around the row max's shuffles, measured
//     slower);
//   - p = 2^(s * scale * log2 e - m) is one FFMA and one ex2.approx.ftz,
//     with m kept in the log2 domain and the max taken on the raw logits;
//     alpha the same way;
//   - a thread copies the same rows and columns of every tile, so their
//     offsets are worked out once (`TileCopy`): a tile's issue is a compare
//     and a cp.async a 16-byte piece;
//   - a 3-slot ring (the tile in use, the next, one in flight) with one
//     barrier a tile, at its top: it publishes tile kt and frees the slot
//     tile kt - 1 was read from, which the same iteration refills; Q lands
//     in the last slot while the first two tiles are in flight;
//   - at D = 8 (Dp 16: the smoke configs' head size) P V is one mma a
//     16-key step at n = 8, so no product lands on the zero columns.
//   A wgmma tile of 16 or 32 columns would waste most of each 128-byte
//   swizzle row, and the phases showed the softmax and the per-tile issue,
//   not the products, setting the pace, so this body stays on mma.sync.
//
//
// Every head size D from 1 up, as the TPU kernel takes (its BlockSpecs span
// the whole head). Let Dp be the smallest of 16, 32, 64, 128 and 256 that is
// at least D (above 256, see "Above 256 columns" below). A launch at D runs
// the body above for (type, Dp),
// instantiated with EXACT = (D == Dp); the real D is a runtime argument that
// does three things where EXACT is false, and nothing where it is true:
//   (a) columns D .. Dp-1 load as zeros: TMA zero-fills them (the tensor
//       map's innermost extent is D), cp.async by its source size, the fma
//       body and the element loader by a mask on their element loads; zero
//       columns add nothing to Q K^T and give zero output columns;
//   (b) stores write columns < D only: the output is the model's
//       [B, S, H, D] viewed as [B, H, S, D], so column D of a row is the
//       next head's (or token's) first;
//   (c) the scale is 1 / sqrt(D) of the real D, computed here, not of Dp.
//
// Rows of no whole 16-byte pieces (the element loader). TMA and cp.async
// move 16-byte pieces, so they take only rows of a whole number of them.
// 16-bit rows at D % 8 != 0 and fp8 rows at D % 16 != 0 run the wgmma body
// all the same where Dp is 64 to 256 (ELEM): its producer warpgroup copies
// the tiles by element (`elem_tile`) in place of TMA, and the consumers'
// code is unchanged. One warp would be too few: a 128-key K/V pair at D =
// 100 is 25,600 elements. So:
//   - the loads are as wide as the rows allow: the widest of 8, 4, 2 and 1
//     bytes that the head's bytes, every stride and every start are
//     multiples of (`elem_src`); a row is cut into units and each producer
//     thread takes one column of units, every few rows, so that a warp's 32
//     threads read consecutive bytes and each works out its column (in the
//     head or not, its slot in the swizzle) once;
//   - 16-bit rows of 8- or 4-byte units (D = 100 in the model's layout, say)
//     are copied by cp.async of that size straight into place
//     (`elem_tile_async`): no register is held and a whole stage's copies
//     are in flight at once, where loads through registers kept few in
//     flight and ran at 1.8x the time (PERF.md); a source size of 0 writes
//     the zeros;
//   - fp8 rows, and 16-bit rows of 2-byte units (odd D, say), go through
//     registers (`elem_tile`): 8 source bytes a unit, four units a thread
//     loaded before they are stored (fewer for narrower loads and at D =
//     256), fp8
//     converted to f16 on the way (exact), so shared memory is the 16-bit
//     layout and the consumers run the f16 code. Staging fp8 by cp.async
//     and converting it in shared memory measured slower (PERF.md);
//   - columns D .. Dp-1 and rows past S are written as zeros (rule (a)), and
//     each unit lands where TMA would put it under the 128-byte swizzle
//     (16-byte piece c of row r at c ^ (r % 8), `swizzle`), which the wgmma
//     descriptors read;
//   - a stage is published by each producer thread: it waits for its own
//     copies (cp.async.wait_group), then fence.proxy.async (its stores are
//     generic-proxy writes that wgmma reads through the async proxy), then
//     arrives on the stage's full mbarrier (128 arrivals in place of TMA's
//     byte count); the empty protocol is TMA's. Q goes first, published
//     while the first K/V copies are in flight;
//   - the producer warpgroup keeps 56 registers a thread (40 at D = 256)
//     and the consumers get 224 (232): 128 x 56 + 256 x 224 = 384 x 168;
//   - the output is stored one value at a time (a row may start at any
//     element), columns < D only.
// The rest of those rows takes the fma body, which reads any type by
// element and computes in fp32: Dp of 16 or 32, and above 256. So the
// rule, stated also in `flash_attention_body` and in the wrapper's
// `body_for`: fp32 -> fma; bf16 / f16, D % 8 == 0 -> wgmma where
// Dp >= 64, mma.sync where Dp <= 32; bf16 / f16, D % 8 != 0 -> wgmma with
// the element loader where Dp is 64 to 256, else fma; fp8 (e4m3fn, e5m2) ->
// wgmma where D % 16 == 0 and Dp is 64 to 256, the element loader at the
// other D of those Dp, else fma.
//
// fp8 q, k, v are read as fp8 from device memory (D bytes a row: no widened
// copy of K or V is made). Rows of whole 16-byte pieces take the wgmma body
// with F8 and TMA (TMA8), which the fp8 tensor cores take as far as they
// can:
//   - S = Q K^T on wgmma's own fp8 form (m64nNk32 .e4m3.e4m3 or .e5m2.e5m2,
//     the kind a template argument, E5), Q and K both K-major straight from
//     the TMA tiles: TMA lands them in rows of min(D, 128) bytes under the
//     swizzle of that row (128 or 64 bytes), which the descriptors read; a
//     k-step is 32 columns, and columns past D, zero-filled, add nothing.
//     Every product of two fp8 values is exact, but the tensor core keeps
//     fewer bits than fp32 while it sums a chain of k-steps into its
//     accumulator: one chain of all D / 32 k-steps missed the plain
//     version by more than one unit in the last place of the output at D
//     = 256 (8 k-steps), and chains of 4 did at D = 128 (`chip_smoke.py`'s
//     fp8 checks), so a chain is at most 2 k-steps (CHAIN): the first
//     chain's accumulator takes each later one's, added in fp32 once that
//     chain is done (at D = 256, three waits a tile for Q K^T);
//   - P V stays on the f16 wgmma with P rounded to f16 as in the f16 body
//     (fp8 would leave P 3 mantissa bits): V is converted fp8 -> f16
//     exactly (e5m2 is an f16's high byte, e4m3fn takes cvt) by the producer
//     warpgroup, off the consumers' path. Its warp 0 issues TMA (Q once,
//     then a ring of fp8 K and V tiles, STAGES deep); warps 1-3 wait on
//     each stage's full barrier, convert its V tile into a ring of f16 V
//     tiles in the 16-bit layout, and arrive on its `v_ready` barrier;
//   - the consumers wait on `v_ready` alone (it implies the stage landed),
//     skip a tile masked whole for their 64 rows without waiting, and free
//     the stage by one arrival a warp on `empty`, as the 16-bit body does:
//     no barrier across both consumer warpgroups is left in the tile loop,
//     so one's softmax runs under the other's products;
//   - shared memory at D = 128 is the fp8 Q tile (16 KB), 2 x 16 KB of fp8
//     K, 2 x 16 KB of fp8 V and 2 x 32 KB of f16 V (145 KB), at D = 256
//     with 64-key tiles 161 KB (`Cfg::SMEM8`); the producer warpgroup keeps
//     40 registers a thread and the consumers get 232.
// P is rounded to f16 as in the f16 body; the output is rounded from fp32
// to fp8 without saturation (`to_fp8`). Rows of no whole 16-byte pieces
// take the element loader, which converts to f16 as it copies (both kinds
// one instantiation, the kind a launch argument). Integer q, k, v (and
// mixed types) never reach this file: the wrapper widens them to fp32
// copies, the reference's `.astype(float32)`.
//
// Above 256 columns (D > 256, Dp = D rounded up to WIDE_DC = 256) no
// warpgroup can hold a whole head's output: the D = 256 body already keeps a
// warpgroup's 64 x 256 fp32 O in 128 registers a thread, and a 64-row Q tile
// at D = 2048 alone is 256 KB of shared memory. So:
//   - up to 512 columns (the pair body, `flash_wgmma_pair_kernel`, 16-bit
//     rows of whole 16-byte pieces) one block takes a 64-row query tile of
//     the whole head with two consumer warpgroups, each owning 256 columns of
//     Q, K, V and O: each computes Q K^T over its own columns, the two 64 x
//     64 partials are added through shared memory, and both run the same
//     softmax and their own P V. Q K^T is done once a tile and Q loaded once
//     (its note below);
//   - above 512 the same body takes a 512-column chunk of the output a
//     block, a grid dimension: its warpgroups sum S over half of the head's
//     64-column pieces each, streamed with Q's through a ring, so each
//     block computes all of S = Q K^T for its query tile and applies P V to
//     its own 512 V columns. The cost, beside the bound: Q K^T is done once
//     a chunk, at D = 1024 (two chunks) 1.5x the operations of one pass and
//     at D = 2048 (four) 2.5x (the chunks of 256 columns that this body
//     replaced: 2.5x and 4.5x); and Q is read again for every KV tile (from
//     L2);
//   - the fma body (fp32, integers and mixed types, fp8 and 16-bit rows of
//     no whole 16-byte pieces) runs in clusters: a cluster of n CTAs a
//     query tile of 64 rows, n the head's 256-column pieces up to
//     FMA_CLUSTER = 8, the portable cluster size (`fma_cluster`). Each CTA
//     is the D = 256 body above (`FmaRing<256>`: 8 x 8 register tiles, its
//     own producer warpgroup and ring, setmaxnreg 40 / 232) on its own 256
//     columns of Q, K, V and O, so K and V cross from L2 once a query tile
//     and Q K^T is done once. A tile's logits are the sum of the n CTAs'
//     partials: each CTA folds its partial tiles and posts them (writes
//     them to a buffer of the tile's parity; lane p of each warp arrives
//     on that parity's mbarrier in CTA p, `mbarrier.arrive.release.cluster`
//     through `mapa`: n x 8 arrivals a phase); after the wait (acquire,
//     cluster scope) each thread reads its row's 8 logits from every CTA's
//     buffer (`ld.shared::cluster`) and sums them in rank order 0 .. n - 1
//     in every CTA, so all hold the same fp32 logits, m and l, and each
//     normalises its own columns as the others do. A CTA posts tile t + 1
//     after its own P V of tile t and runs Q K^T of tile t + 1 between
//     posting tile t and waiting for it, so the exchange's latency and
//     the cluster's skew lie under a product: with the wait right after
//     the post, the exchange took 0.18, 0.27 and 0.42 of a warp's time at
//     n = 2, 4 and 8 (`flash_phases.py --body fma_wide`, PERF.md), for a
//     release at cluster scope is a MEMBAR.ALL.GPU, and one lane posting
//     to every peer in turn paid it n times; now one instruction a warp
//     pays it once. One barrier a tile is enough with two buffers: a CTA
//     writes a parity's buffer again two tiles on, after the wait of the
//     tile between, for which every warp of the cluster arrived only after
//     reading this one. (A cluster barrier would hold the producer
//     warpgroups, which run ahead, to the consumers' pace.) The ring holds
//     a tile's K items before the V of the tile before it, the order the
//     consumers take them in. The softmax and P V then run as
//     in the D = 256 body over the CTA's 256 output columns; a CTA stores
//     only its columns < D, and its shared memory outlives its peers'
//     reads by one cluster barrier at the end. 228 KB of shared memory a
//     CTA (the D = 256 body's 212 and 16 of partials), one CTA an SM; a
//     cluster of 8 must fit in a GPC, so the H100 holds 15 at once (120
//     SMs busy), of 4 30 (120), of 2 66 (all 132:
//     `flash_attention_fma_clusters`). Above 2048 columns the clusters
//     stay at 8: a cluster for every chunk of 8 pieces of the output, a
//     grid dimension, CTA r summing Q K^T over pieces r, r + 8, ... (a
//     later piece's Q through its ring, in two items of 32 rows, beside
//     its K) and running P V over piece 8 chunk + r (none past the head).
//     Each chunk's cluster sums all of Q K^T, so Q K^T is done ceil(Dp /
//     2048) times (`qk_passes`: at D 2304 twice, 1.5x the operations of
//     one pass with P V), and a cluster keeps the pace of its CTA of most
//     pieces (at D 2304 rank 0 sums two while the others wait). Bound, as
//     below 256: the fp32 FMA peak; at fp32 D512 a warp spends 0.43 of its
//     time on Q K^T, 0.33 on P V and 0.13 on the exchange.
// `flash_attention_wide_blocks` states the blocks a query tile each takes.
// Rules (a)-(c) hold for every chunk and warpgroup: columns past D load as
// zeros (TMA's zero fill, the element loads' mask), a block or warpgroup
// stores only its columns < D, and the scale is 1 / sqrt(D) of the whole
// head.
//
// Left for a later change: one K/V tile load serving the blocks of all the
// query heads of a GQA group (a cluster and TMA multicast; today each of the
// 8 query heads of a KV head at qwen2.5-3b's shape loads the same tiles),
// persistent blocks (one tile's epilogue and the next one's first loads
// under the products), a tile's P V issued with the next tile's Q K^T so
// that a warpgroup's own softmax runs under it (tried at D = 256 on this
// ring, it was slower: the pending P V holds the second stage, so the next
// tile's loads wait; it needs K and V freed apart, PERF.md), D = 16 / 32 on
// wgmma, and the element loader below 64 columns and above 256.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;

// The 16-bit operand types of the tensor-core bodies. bf16 and f16 take the
// same code; they differ in the type field of mma.sync and wgmma, in the
// rounding of P to the operand type (`pack2`) and in the TMA map's data type.
template <typename T> struct Op16;
template <> struct Op16<__nv_bfloat16> {
  static constexpr bool kF16 = false;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <> struct Op16<__half> {
  static constexpr bool kF16 = true;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per tile
// below any real logit in log2 units, above any masked one (NEG_INF times
// the scale): the running max of a row that has met no key yet
constexpr float NO_KEY = NEG_INF * 1e-10f;

// ---------------------------------------------------------------------------
// float32 on the CUDA cores, the fma body (its design: the note at the top).
// One block of FMA_NT consumer threads and a producer warpgroup a query
// tile (above 256 columns, a cluster of such blocks); the producers lower
// their registers to FMA_P_REGS so that the consumers can raise theirs to
// FMA_C_REGS (384 threads are allotted 168 registers a thread: 128 x 40 +
// 256 x 232 = 384 x 168).
constexpr int FMA_NT = 256;       // consumer threads: 8 warps
constexpr int FMA_PT = 128;       // producer threads: a warpgroup
constexpr int FMA_P_REGS = 40, FMA_C_REGS = 232;
constexpr int FMA_PAD = 8;        // words past D in a row of Q, K and V
constexpr unsigned FULL_MASK = 0xffffffffu;
// Columns of a piece of the head above 256: a block's output columns in the
// fma body's clusters, a consumer warpgroup's in the pair body.
constexpr int WIDE_DC = 256;
constexpr int FMA_CLUSTER = 8;    // CTAs a cluster at most (the portable size)

// Query rows a block of the fma body at Dp (`FmaRing`'s BMF) for a launch
// over B x Hq heads of S rows on a card of `sms` SMs: 64 at Dp 256 and
// above; at Dp 64 and 128, 64 where tiles of 128 rows would give fewer
// blocks than the card has SMs (int8 at B2 Hq8 S200 D64: 32 blocks at 128
// rows, 64 at 64), else 128; 128 at Dp 16 and 32. The wrapper's `fma_rows`
// states the same rule.
int fma_rows(int Dp, int B, int Hq, int S, int sms) {
  if (Dp >= WIDE_DC) return 64;
  if ((Dp == 64 || Dp == 128) && (long long)((S + 127) / 128) * B * Hq < sms)
    return 64;
  return 128;
}

// The tiles of the body at head size D (Dp) and ROWS query rows a block. A
// thread's Q K^T is an 8 x 8 tile of logits (8 query rows, 8 keys) summed
// over its share of D, one of KSPLIT threads that split D between them; its
// P V an 8-row x OC-column tile of the output, over every key of the tile.
// WIDE: a CTA of a cluster above 256 columns (D = WIDE_DC), with the
// buffers of its partial logits.
template <int D, int ROWS = (D == WIDE_DC ? 64 : 128), bool WIDE = false>
struct FmaRing {
  static constexpr int BMF = ROWS;                  // query rows a block
  static constexpr int BNF = D == WIDE_DC ? 32 : 64;   // keys a K or V tile
  static constexpr int KSPLIT = FMA_NT * 64 / (BMF * BNF);   // 2, 4 or 8
  static constexpr int KG = BNF / 8;                // key groups
  static constexpr int RS = 8 / KSPLIT;             // softmax rows a thread
  static constexpr int NCH = D / 4 / KSPLIT;        // 4-column pieces a thread
  static constexpr int OC = BMF * D / (8 * FMA_NT); // output columns a thread
  static constexpr int CG = D / OC;                 // column groups
  static constexpr int SLOTS = D == 128 && BMF == 128 ? 3 : 4;   // ring slots
  static constexpr int WS = D + FMA_PAD;            // row stride (floats)
  static constexpr int PS = BMF + 4;                // row stride of P^T
  static constexpr int Q_WORDS = BMF * WS;
  static constexpr int SLOT_WORDS = BNF * WS;
  // the partial logits of two tiles (by parity), a thread's 8 as two float4
  static constexpr int XCH_WORDS = WIDE ? 2 * 8 * FMA_NT : 0;
  // barriers (full, empty a slot, q_full; two of the partials where WIDE),
  // then Q, the slots, P^T, alpha, the row sums and the partials
  static constexpr int BAR_BYTES = 16 * (SLOTS + 1) + (WIDE ? 16 : 0);
  static constexpr size_t SMEM =
      BAR_BYTES + sizeof(float) * ((size_t)Q_WORDS + SLOTS * SLOT_WORDS +
                                   BNF * PS + 2 * BMF + XCH_WORDS);
  static_assert(KSPLIT * BMF * BNF == FMA_NT * 64, "whole logit tiles");
  static_assert(OC * CG == D && (BMF / 8) * CG == FMA_NT, "whole O tiles");
  static_assert(OC == 8 || OC <= 4, "one vector, or two of 4");
  static_assert(!WIDE || (D == WIDE_DC && BMF == 2 * BNF && RS == 1),
                "a later piece's Q is two ring items; one row a thread");
  static_assert(SMEM <= 232448, "one block an SM");
};

// The producer warpgroup's aload of ROWS rows (row0 on; zeros past S) of
// a [*, dh] operand into a shared tile of row stride WS, thread `pt` of
// FMA_PT, in loads of `load` bytes (`fma_load`): 16, float32 rows of whole
// 16-byte pieces, by cp.async, zero-filled past dh and S, each thread's
// arrival on `bar` made by the completion of its copies; else units of
// `load` / sizeof(E) elements (8 bytes at most: the widest that dh, the
// strides and the starts allow), widened to float32 as they are loaded,
// columns dh .. D - 1 zero, each thread arriving after its stores.
template <typename E, int D, int ROWS, int UE>
__device__ __forceinline__ void fma_aload_units(float* dst, const E* src,
                                                long long row_stride,
                                                int row0, int S, int dh,
                                                int pt) {
  constexpr int WS = FmaRing<D>::WS, UPR = D / UE;   // units a row
  struct alignas(UE * sizeof(E)) Unit { E e[UE]; };
  // loads in flight a thread: 32 bytes of 8-byte units, 8 of narrower ones
  constexpr int U = sizeof(Unit) == 8 ? 4 : 8;
  for (int i0 = pt; i0 < ROWS * UPR; i0 += FMA_PT * U) {
    Unit x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + FMA_PT * u, r = i / UPR, c = i % UPR * UE;
      if (i < ROWS * UPR && row0 + r < S && c < dh) {
        x[u] = *reinterpret_cast<const Unit*>(src + (row0 + r) * row_stride +
                                              c);
      } else {
        x[u] = Unit{};
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + FMA_PT * u;
      if (i < ROWS * UPR) {
        float* to = dst + (i / UPR) * WS + i % UPR * UE;
#pragma unroll
        for (int e = 0; e < UE; e += 4) {
          if constexpr (UE >= 4) {
            *reinterpret_cast<float4*>(to + e) =
                make_float4(to_float(x[u].e[e]), to_float(x[u].e[e + 1]),
                            to_float(x[u].e[e + 2]), to_float(x[u].e[e + 3]));
          } else {
#pragma unroll
            for (int f = 0; f < UE; ++f) to[f] = to_float(x[u].e[f]);
          }
        }
      }
    }
  }
}

template <typename E, int D, int ROWS>
__device__ __forceinline__ void fma_aload(float* dst, const E* src,
                                          long long row_stride, int row0,
                                          int S, int dh, int load,
                                          uint64_t* bar, int pt) {
  constexpr int WS = FmaRing<D>::WS;
  if constexpr (sizeof(E) == 4) {
    if (load == 16) {
      constexpr int CPR = D / 4;                  // 16-byte pieces a row
      const uint32_t base = hopper::smem_u32(dst);
#pragma unroll 4
      for (int i = pt; i < ROWS * CPR; i += FMA_PT) {
        const int r = i / CPR, c = i % CPR;
        const bool in = row0 + r < S && c * 4 < dh;
        const E* from = in ? src + (row0 + r) * row_stride + c * 4 : src;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         base + (uint32_t)((r * WS + c * 4) * 4)),
                     "l"(from), "r"(in ? 16 : 0)
                     : "memory");
      }
      asm volatile(
          "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
              hopper::smem_u32(bar))
          : "memory");
      return;
    }
  }
  const int ue = load / (int)sizeof(E);           // elements a unit
  if (sizeof(E) <= 2 && ue == 4)
    fma_aload_units<E, D, ROWS, sizeof(E) <= 2 ? 4 : 1>(
        dst, src, row_stride, row0, S, dh, pt);
  else if (sizeof(E) == 1 && ue == 8)
    fma_aload_units<E, D, ROWS, sizeof(E) == 1 ? 8 : 1>(
        dst, src, row_stride, row0, S, dh, pt);
  else if (ue == 2)
    fma_aload_units<E, D, ROWS, 2>(dst, src, row_stride, row0, S, dh, pt);
  else
    fma_aload_units<E, D, ROWS, 1>(dst, src, row_stride, row0, S, dh, pt);
  hopper::mbar_arrive(bar);                       // release: the stores
}

// Barrier 1 over the consumer threads only (the producer warp runs on).
__device__ __forceinline__ void fma_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(FMA_NT) : "memory");
}

// One step of the fold of the KSPLIT partial logit tiles: the thread and
// its partner lane ^ OFF hold rows [0, N) summed over their own columns of
// D; each keeps one half of the rows (the upper where bit OFF of its lane is
// set) with the partner's sum of them added.
template <int OFF, int N>
__device__ __forceinline__ void fold_rows(float (&s)[8][8], int lane) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float send = upper ? s[i][j] : s[i + N / 2][j];
      const float keep = upper ? s[i + N / 2][j] : s[i][j];
      s[i][j] = keep + __shfl_xor_sync(FULL_MASK, send, OFF);
    }
}

// The cluster's logits of this thread's row and 8 keys: the partials that
// each of the n CTAs wrote at `mine`'s place of its buffer, summed in rank
// order 0 .. n - 1, the same order in every CTA, so that all hold the same
// fp32 logits (and so the same m and l).
__device__ __forceinline__ void sum_partials(float (&s)[8][8],
                                             const float4* mine, int n) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float4 y[FMA_CLUSTER];
#pragma unroll
    for (int p = 0; p < FMA_CLUSTER; ++p)
      if (p < n) y[p] = hopper::ld_cluster_f4(
                     hopper::cluster_addr(mine + half * FMA_NT, p));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int p = 0; p < FMA_CLUSTER; ++p)
      if (p < n) {
        x.x += y[p].x;
        x.y += y[p].y;
        x.z += y[p].z;
        x.w += y[p].w;
      }
    s[0][4 * half] = x.x;
    s[0][4 * half + 1] = x.y;
    s[0][4 * half + 2] = x.z;
    s[0][4 * half + 3] = x.w;
  }
}

// The fma body. Up to 256 columns (WIDE false) a block owns a query tile of
// one head. Above (WIDE, D = WIDE_DC, launched in clusters of n CTAs, n the
// head's 256-column pieces up to FMA_CLUSTER) CTA rank r of a cluster sums
// Q K^T over pieces r, r + n, ... of the head, the cluster adds the n
// partial logit tiles through distributed shared memory, and the CTA runs
// the softmax and P V over its own piece of the output, piece chunk n + r
// (the head's pieces past n * FMA_CLUSTER in further clusters, a grid
// dimension, each summing all of Q K^T).
template <typename E, int D, bool EXACT, int ROWS, bool WIDE>
__global__ void __launch_bounds__(FMA_NT + FMA_PT, 1)
flash_fma_kernel(const E* __restrict__ q, const E* __restrict__ k,
                 const E* __restrict__ v, E* __restrict__ o, int S, int Hq,
                 int group, int causal, int window, float scale_log2, int dh,
                 int load, long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss,
                 long long o_sb, long long o_sh, long long o_ss) {
  using C = FmaRing<D, ROWS, WIDE>;
  using hopper::fast_exp2;
  using hopper::mbar_arrive;
  using hopper::mbar_wait;
  constexpr int BMF = C::BMF, BNF = C::BNF, KSPLIT = C::KSPLIT, KG = C::KG;
  constexpr int RS = C::RS, OC = C::OC, CG = C::CG, WS = C::WS, PS = C::PS;
  constexpr int SLOTS = C::SLOTS;
  extern __shared__ __align__(16) unsigned char smem_fma[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_fma);   // a slot landed
  uint64_t* empty = full + SLOTS;                 // a slot read by all
  uint64_t* q_full = empty + SLOTS;               // Q landed
  uint64_t* xfull = q_full + 2;                   // a parity's partials landed
  float* Qs = reinterpret_cast<float*>(smem_fma + C::BAR_BYTES);
  float* ring = Qs + C::Q_WORDS;
  float* Pt = ring + SLOTS * C::SLOT_WORDS;       // P^T [key][row]
  float* alpha_s = Pt + BNF * PS;                 // a row's alpha
  float* lsum_s = alpha_s + BMF;                  // a row's sum at the end
  float4* xch = reinterpret_cast<float4*>(lsum_s + BMF);   // [2][2][FMA_NT]

  // the query tile is the slowest grid dimension, heaviest first across
  // all heads and batches, so that causal attention's light tiles fill the
  // last wave
  const int qt = gridDim.y - 1 - blockIdx.y;
  // the cluster: ncta CTAs, this one of rank `rank`; the head's 256-column
  // pieces (npc), this CTA's Q K^T pieces rank, rank + ncta, ... (npk of
  // them) and its output piece vp, if the head has one
  const int ncta = WIDE ? (int)hopper::cluster_size() : 1;
  const int rank = WIDE ? (int)(blockIdx.x % ncta) : 0;
  const int npc = WIDE ? (dh + WIDE_DC - 1) / WIDE_DC : 1;
  const int chunks = (npc + ncta - 1) / ncta;
  const int u = blockIdx.x / ncta, bh = u / chunks;
  const int h = bh % Hq, b = bh / Hq;
  const int hk = h / group;
  const int npk = (npc - rank + ncta - 1) / ncta;
  const int vp = (u % chunks) * ncta + rank;
  const bool has_v = vp < npc;
  const int qc0 = rank * WIDE_DC, vc0 = vp * WIDE_DC;  // 0 up to 256 columns
  const int Dh = EXACT ? D : dh - vc0;            // columns of the output
  const int tid = threadIdx.x, lane = tid & 31;
  const int q0 = qt * BMF;

  // KV tiles that causality and the window leave to this query tile
  const int nkt = (S + BNF - 1) / BNF;
  const int q_last = min(q0 + BMF, S) - 1;
  const int kt_hi = causal ? min(nkt, q_last / BNF + 1) : nkt;
  int kt_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / BNF;

  if (tid < SLOTS) {
    hopper::mbar_init(&full[tid], FMA_PT);        // the producers
    hopper::mbar_init(&empty[tid], FMA_NT / 32);  // the consumer warps
  }
  if (tid == SLOTS) hopper::mbar_init(q_full, FMA_PT);
  if (WIDE && tid < 2)            // every consumer warp of the cluster
    hopper::mbar_init(&xfull[tid], ncta * (FMA_NT / 32));
  hopper::fence_barrier_init();
  if constexpr (WIDE) {           // the peers' barriers are ready
    hopper::cluster_arrive();
    hopper::cluster_wait();
  } else {
    __syncthreads();
  }

  const E* qb = q + b * q_sb + h * q_sh;
  if (tid >= FMA_NT) {            // the producers: Q, then the ring's items
    hopper::setmaxnreg_dec<FMA_P_REGS>();
    const int pt = tid - FMA_NT;
    fma_aload<E, D, BMF>(Qs, qb + qc0, q_ss, q0, S, dh - qc0, load, q_full,
                         pt);
    const E* kb = k + b * k_sb + hk * k_sh;
    const E* vb = v + b * v_sb + hk * v_sh;
    int it = 0;                   // items issued
    // BNF rows of an operand from row row0 and column c0 into the next slot
    auto put = [&](const E* src, long long ss, int row0, int c0) {
      const int slot = it % SLOTS;
      if (it >= SLOTS)            // every consumer warp has left the slot
        mbar_wait(&empty[slot], (uint32_t)((it / SLOTS - 1) & 1));
      fma_aload<E, D, BNF>(ring + slot * C::SLOT_WORDS, src + c0, ss, row0,
                           S, dh - c0, load, &full[slot], pt);
      ++it;
    };
    // a tile's K items: K of each Q K^T piece (the Q of a piece after
    // the first before it, in two halves of BNF rows)
    auto put_k = [&](int kt) {
      for (int e = 0; e < npk; ++e) {
        const int c0 = qc0 + e * ncta * WIDE_DC;
        if (WIDE && e > 0) {
          put(qb, q_ss, q0, c0);
          put(qb, q_ss, q0 + BNF, c0);
        }
        put(kb, k_ss, kt * BNF, c0);
      }
    };
    // then V of the output's piece; the clusters' consumers take a tile's
    // K items before the V of the tile before it (its Q K^T runs under
    // that tile's exchange), so the ring holds them in that order
    if (WIDE && kt_lo < kt_hi) put_k(kt_lo);
    for (int kt = kt_lo; kt < kt_hi; ++kt) {
      if (!WIDE)
        put_k(kt);
      else if (kt + 1 < kt_hi)
        put_k(kt + 1);
      if (has_v) put(vb, v_ss, kt * BNF, vc0);
    }
    if constexpr (WIDE) {         // the consumers' last barrier
      hopper::cluster_arrive();
      hopper::cluster_wait();
    }
    return;
  }
  hopper::setmaxnreg_inc<FMA_C_REGS>();

  // Q K^T and the softmax: logit tile (rg, kg) of rows rg * 8 .. + 7 and
  // keys kg + KG j, its columns of D split into 4-column pieces part +
  // KSPLIT i among the KSPLIT lanes next to each other that hold it
  const int part = tid % KSPLIT, tile = tid / KSPLIT;
  const int rg = tile / KG, kg = tile % KG;
  const int rbase = rg * 8 + part * RS;           // the softmax's rows
  // P V: rows org * 8 .. + 7, columns (OC = 8) 4 cg .. + 3 and D / 2 + 4 cg
  // .. + 3, else OC cg .. + OC - 1
  const int org = tid / CG, cg = tid % CG;
  auto col = [&](int c) {
    return OC == 8 ? (c < 4 ? 4 * cg + c : D / 2 + 4 * cg + c - 4)
                   : OC * cg + c;
  };

  float m[RS], l[RS];                             // m in log2 units
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  float acc[8][OC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;

  mbar_wait(q_full, 0);
  int it = 0;                     // ring items taken, in the ring's order
  // Q K^T of the next tile whose K is in the ring, over this CTA's pieces,
  // folded: this lane keeps RS rows of it
  auto qk = [&](float (&s)[8][8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int x = 0; x < 8; ++x) s[i][x] = 0.f;
    for (int e = 0; e < npk; ++e) {
      // this thread's 8 rows of Q: the first piece's in its own buffer, a
      // later one's in the two ring items before its K
      const float* qrow = Qs + rg * 8 * WS;
      if (WIDE && e > 0) {
        const int s0 = it % SLOTS, s1 = (it + 1) % SLOTS;
        mbar_wait(&full[s0], (uint32_t)((it / SLOTS) & 1));
        mbar_wait(&full[s1], (uint32_t)(((it + 1) / SLOTS) & 1));
        qrow = ring + (rg < BNF / 8 ? s0 : s1) * C::SLOT_WORDS +
               (rg % (BNF / 8)) * 8 * WS;
        it += 2;
      }
      const int sk = it % SLOTS;
      const float* Ks = ring + sk * C::SLOT_WORDS;
      mbar_wait(&full[sk], (uint32_t)((it / SLOTS) & 1));     // getfin: K
      // 8 rows of Q and 8 keys of K a 4-column piece: 16 LDS.128 for 256
      // FFMAs, 4 a word read
#pragma unroll 2
      for (int ci = 0; ci < C::NCH; ++ci) {
        const int c = 4 * (part + KSPLIT * ci);
        float4 qv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qrow + i * WS + c);
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const float4 kv =
              *reinterpret_cast<const float4*>(Ks + (kg + KG * x) * WS + c);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            s[i][x] = fmaf(qv[i].x, kv.x, s[i][x]);
            s[i][x] = fmaf(qv[i].y, kv.y, s[i][x]);
            s[i][x] = fmaf(qv[i].z, kv.z, s[i][x]);
            s[i][x] = fmaf(qv[i].w, kv.w, s[i][x]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&empty[sk]);                  // K's slot is free
        if (WIDE && e > 0) {                      // and Q's two
          mbar_arrive(&empty[(it - 2) % SLOTS]);
          mbar_arrive(&empty[(it - 1) % SLOTS]);
        }
      }
      ++it;
    }
    // the KSPLIT partial tiles summed
    if constexpr (KSPLIT == 2) {
      fold_rows<1, 8>(s, lane);
    } else if constexpr (KSPLIT == 4) {
      fold_rows<2, 8>(s, lane);
      fold_rows<1, 4>(s, lane);
    } else {
      fold_rows<4, 8>(s, lane);
      fold_rows<2, 4>(s, lane);
      fold_rows<1, 2>(s, lane);
    }
  };
  // (WIDE) the exchange of the cluster's partial logits. This thread's
  // place in the buffer of tile j's parity; `post`: its 8 partials written
  // there, then, each warp, lane p's arrival on that parity's barrier in
  // CTA p (n x 8 arrivals a phase; each a release at cluster scope, a
  // MEMBAR.ALL.GPU: one a warp, not one a peer). A tile's partials are
  // posted before the wait for the tile before it is over, and read after
  // the next tile's Q K^T: the exchange's latency and the cluster's skew
  // lie under that product. Two buffers are enough: a CTA posts tile j + 1
  // after its wait for tile j, for which every warp of the cluster arrived
  // only after reading tile j - 1, the buffer's last.
  auto buf = [&](int j) { return xch + (j & 1) * 2 * FMA_NT + tid; };
  auto post = [&](const float (&x)[8], int j) {
    float4* mine = buf(j);
    mine[0] = make_float4(x[0], x[1], x[2], x[3]);
    mine[FMA_NT] = make_float4(x[4], x[5], x[6], x[7]);
    __syncwarp();
    if (lane < ncta) hopper::mbar_arrive_cluster(&xfull[j & 1], lane);
  };

  float s[8][8];
  if constexpr (WIDE) {
    if (kt_lo < kt_hi) {
      qk(s);
      post(s[0], 0);
    }
  }
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int j = kt - kt_lo, k0 = kt * BNF;
    float nxt[8];                 // (WIDE) the next tile's partials
    if constexpr (WIDE) {
      if (kt + 1 < kt_hi) {
        qk(s);
#pragma unroll
        for (int x = 0; x < 8; ++x) nxt[x] = s[0][x];
      }
      hopper::mbar_wait_cluster(&xfull[j & 1], (uint32_t)((j >> 1) & 1));
      sum_partials(s, buf(j), ncta);
    } else {
      qk(s);
    }
    if (has_v) {                  // (WIDE: else no output columns)
      // every consumer is past the last tile's P V: P^T and alpha are free
      fma_consumers_sync();
      // mask only where the tile straddles S, the diagonal or the window
      // edge
      const bool straddles = k0 + BNF > S ||
                             (causal && k0 + BNF - 1 > q0) ||
                             (window > 0 && k0 <= q0 + BMF - 1 - window);
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        const int r = q0 + rbase + i;
        if (straddles) {
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const int c = k0 + kg + KG * x;
            bool ok = c < S;
            if (causal) ok = ok && c <= r;
            if (window > 0) ok = ok && c > r - window;
            if (!ok) s[i][x] = NEG_INF;
          }
        }
        // the row max on the raw logits (the scale is positive), over the
        // KG lanes of the row's keys
        float tmax = s[i][0];
#pragma unroll
        for (int x = 1; x < 8; ++x) tmax = fmaxf(tmax, s[i][x]);
#pragma unroll
        for (int off = KSPLIT; off < KSPLIT * KG; off <<= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(FULL_MASK, tmax, off));
        // p = 2^(s * scale * log2 e - m): one FFMA and one ex2. A row that
        // has met no key yet has its max at the mask's level: subtract 0
        // there, so that its masked p are 2^-1e29 = 0
        const float mn = fmaxf(m[i], tmax * scale_log2);
        const float alpha = fast_exp2(m[i] - mn);
        const float sub = mn > NO_KEY ? mn : 0.f;
        float psum = 0.f;
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const float p = fast_exp2(fmaf(s[i][x], scale_log2, -sub));
          psum += p;
          Pt[(kg + KG * x) * PS + rbase + i] = p;
        }
        l[i] = l[i] * alpha + psum;   // this lane's share of the row sum
        m[i] = mn;
        if (kg == 0) alpha_s[rbase + i] = alpha;
      }
      fma_consumers_sync();           // P^T and alpha are written

      // acc = acc alpha + P V: 8 rows of P^T and 8 columns of V a key, 4
      // LDS.128 for 64 FFMAs
      {
        const float4 a0 =
            *reinterpret_cast<const float4*>(alpha_s + org * 8);
        const float4 a1 =
            *reinterpret_cast<const float4*>(alpha_s + org * 8 + 4);
        const float al[8] = {a0.x, a0.y, a0.z, a0.w,
                             a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < OC; ++c) acc[i][c] *= al[i];
      }
      const int sv = it % SLOTS;
      const float* Vs = ring + sv * C::SLOT_WORDS;
      mbar_wait(&full[sv], (uint32_t)((it / SLOTS) & 1));     // getfin: V
#pragma unroll 4
      for (int n = 0; n < BNF; ++n) {
        const float4 p0 =
            *reinterpret_cast<const float4*>(Pt + n * PS + org * 8);
        const float4 p1 =
            *reinterpret_cast<const float4*>(Pt + n * PS + org * 8 + 4);
        const float pr[8] = {p0.x, p0.y, p0.z, p0.w,
                             p1.x, p1.y, p1.z, p1.w};
        float vv[OC];
        const float* vrow = Vs + n * WS;
        if constexpr (OC == 8) {
          const float4 v0 = *reinterpret_cast<const float4*>(vrow + 4 * cg);
          const float4 v1 =
              *reinterpret_cast<const float4*>(vrow + D / 2 + 4 * cg);
          vv[0] = v0.x; vv[1] = v0.y; vv[2] = v0.z; vv[3] = v0.w;
          vv[4] = v1.x; vv[5] = v1.y; vv[6] = v1.z; vv[7] = v1.w;
        } else if constexpr (OC == 4) {
          const float4 v0 = *reinterpret_cast<const float4*>(vrow + 4 * cg);
          vv[0] = v0.x; vv[1] = v0.y; vv[2] = v0.z; vv[3] = v0.w;
        } else if constexpr (OC == 2) {
          const float2 v0 = *reinterpret_cast<const float2*>(vrow + 2 * cg);
          vv[0] = v0.x; vv[1] = v0.y;
        } else {
          vv[0] = vrow[cg];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < OC; ++c)
            acc[i][c] = fmaf(pr[i], vv[c], acc[i][c]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[sv]);       // V's slot is free
      ++it;
    }
    if constexpr (WIDE) {
      if (kt + 1 < kt_hi) post(nxt, j + 1);
    }
  }
  // no peer reads this CTA's partials after its last exchange
  if constexpr (WIDE) hopper::cluster_arrive();

  if (has_v) {
    // the row sums over the KG lanes of each row, through shared memory to
    // the rows of the output tiles
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      float x = l[i];
#pragma unroll
      for (int off = KSPLIT; off < KSPLIT * KG; off <<= 1)
        x += __shfl_xor_sync(FULL_MASK, x, off);
      if (kg == 0) lsum_s[rbase + i] = x;
    }
    fma_consumers_sync();
    E* ob = o + b * o_sb + h * o_sh + vc0;        // this CTA's columns
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = q0 + org * 8 + i;
      if (r < S) {
        const float inv = 1.f / fmaxf(lsum_s[org * 8 + i], 1e-30f);
#pragma unroll
        for (int c = 0; c < OC; ++c)
          if (EXACT || col(c) < Dh)
            ob[r * o_ss + col(c)] = from_float<E>(acc[i][c] * inv);
      }
    }
  }
  // ... and this CTA's shared memory outlives every peer's reads of it
  if constexpr (WIDE) hopper::cluster_wait();
}

// ---------------------------------------------------------------------------
// bfloat16 / float16 at Dp 16 and 32 on the tensor cores (mma.sync). Block =
// 4 warps x 16 query rows (see the note at the top for what bounds it).
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row): a0 = (g, 2t..2t+1)  a1 = (g+8, 2t..)  a2 = (g, 2t+8..)
//                   a3 = (g+8, 2t+8..)
//   B (16x8, col):  b0 = (k 2t..2t+1, n g)   b1 = (k 2t+8..2t+9, n g)
//   C (16x8):       c0, c1 = (g, 2t..2t+1)   c2, c3 = (g+8, 2t..2t+1)
// K rows are [key][d], which is B in "col" form for Q K^T; V rows [key][d]
// are B for P V only transposed, which ldmatrix.trans does on the way in.
// Rows are padded by 4 words (WS % 8 == 4): the 8 g x 4 t word reads of a B
// fragment hit 32 different banks, and rows stay 16-byte aligned for ldmatrix.
constexpr int MMA_NT = 128;
// K/V tiles in the ring: the one in use, the next (landed or landing) and
// the one in flight, so that one barrier a tile both publishes a tile and
// frees the slot the tile before it was read from
constexpr int MMA_SLOTS = 3;
static_assert(BM == BN, "the Q tile borrows a K slot");

template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
#define MMA_16816(TY)                                                     \
  asm volatile(                                                           \
      "mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 "          \
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
  if constexpr (Op16<T>::kF16)
    MMA_16816("f16");
  else
    MMA_16816("bf16");
#undef MMA_16816
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* smem_ptr) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem_ptr) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// lo and hi rounded to T, packed into one register (lo in the low half)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (Op16<T>::kF16) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

template <int D> struct MmaCfg {
  static constexpr int NW = D / 2;                // words per row
  static constexpr int WS = NW + 4;               // padded row stride (words)
  static constexpr int TILE = BN * WS;            // words of one K or V tile
  // a ring of MMA_SLOTS (K, V) tile pairs; the Q tile borrows the last
  // slot's K area until its fragments are in registers
  static constexpr size_t SMEM =
      sizeof(uint32_t) * (size_t)MMA_SLOTS * 2 * TILE;
};

// The AMI pattern in its Hopper form: aload = cp.async (16 bytes a request,
// issued and forgotten), request group = commit_group, getfin = wait_group.
__device__ __forceinline__ void cp_async_16(void* smem_ptr, const void* gmem,
                                            int src_bytes) {
  // src_bytes < 16 zero-fills the rest of the 16 bytes (0: nothing is read)
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One thread's copies of a [BN, D] 16-bit tile (rows [row0, row0 + BN) of
// an operand) into a shared tile: CPT 16-byte pieces, the same rows and
// columns of every tile, so their offsets are worked out once and a tile's
// issue is a compare and a cp.async a piece. Rows past S and, unless EXACT,
// the pieces at or past column dh (a multiple of 8) are zero-filled.
template <typename T, int D, bool EXACT>
struct TileCopy {
  static constexpr int CPR = D / 8;               // 16-byte pieces a row
  static constexpr int CPT = BN * CPR / MMA_NT;   // pieces a thread
  static_assert(CPT * MMA_NT == BN * CPR, "whole pieces a thread");
  int row[CPT];                 // the piece's row in the tile
  int dst[CPT];                 // its words into the shared tile
  long long src[CPT];           // its elements from the tile's first row
  bool col_in[CPT];             // a column of the head (else zeros)

  __device__ __forceinline__ TileCopy(long long row_stride, int dh) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int idx = threadIdx.x + j * MMA_NT;
      const int r = idx / CPR, c = idx % CPR;
      row[j] = r;
      dst[j] = r * MmaCfg<D>::WS + c * 4;
      col_in[j] = EXACT || c * 8 < dh;
      src[j] = r * row_stride + (col_in[j] ? c * 8 : 0);
    }
  }
  // aload of the tile whose first row is `base`, `rows` of them before S;
  // returns at once
  __device__ __forceinline__ void issue(uint32_t* tile, const T* base,
                                        int rows) const {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const bool in = row[j] < rows && col_in[j];
      cp_async_16(tile + dst[j], in ? base + src[j] : base, in ? 16 : 0);
    }
  }
};

// The body: FlashAttention-2 on mma.sync.m16n8k16, 64 x 64 tiles, each warp
// 16 query rows of the block's 64 and all of D. At Dp 16 and 32 the two
// products are a few mma a tile, so the per-logit softmax and the per-tile
// costs are the body; the note at the top says what it does about them.
template <typename T, int D, bool EXACT>
__global__ void __launch_bounds__(MMA_NT)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S,
                 int group, int causal,
                 int window, float scale_log2, int dh, long long q_sb,
                 long long q_sh, long long q_ss, long long k_sb,
                 long long k_sh, long long k_ss, long long v_sb,
                 long long v_sh, long long v_ss, long long o_sb,
                 long long o_sh, long long o_ss) {
  using hopper::fast_exp2;
  constexpr int WS = MmaCfg<D>::WS;
  constexpr int KS = D / 16;            // k-steps of Q K^T
  constexpr int NB = BN / 8;            // 8-key column blocks of the logits
  // 8-wide column blocks of the output: at Dp 16 a head of D < Dp is D = 8
  // (rows of whole 16-byte pieces), one block, so P V takes one
  // mma.m16n8k16 a k-step and none lands on zero columns
  constexpr int DB = !EXACT && D == 16 ? 1 : D / 8;
  extern __shared__ uint32_t smem[];
  constexpr int TILE = MmaCfg<D>::TILE;
  uint32_t* Qs = smem + (MMA_SLOTS - 1) * 2 * TILE;   // the last slot's K

  const int qt = gridDim.x - 1 - blockIdx.x;      // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * BM;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  const int nkt = (S + BN - 1) / BN;
  const int q_last = min(q0 + BM, S) - 1;
  const int kt_hi = causal ? min(nkt, q_last / BN + 1) : nkt;
  int kt_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / BN;

  // aload of KV tile kt into its slot, one request group a tile (an empty
  // one past the last tile, so that "one group pending" always means the
  // tile after the one waited for)
  const TileCopy<T, D, EXACT> kc(k_ss, dh), vc(v_ss, dh);
  auto issue = [&](int kt) {
    if (kt < kt_hi) {
      uint32_t* slot = smem + ((kt - kt_lo) % MMA_SLOTS) * 2 * TILE;
      const int k0 = kt * BN;
      kc.issue(slot, kb + k0 * k_ss, S - k0);
      vc.issue(slot + TILE, vb + k0 * v_ss, S - k0);
    }
    cp_async_commit();
  };
  // Q, then the first two K/V tiles, all in flight together: Q lands in the
  // last slot, which no tile takes before the loop's first barrier
  TileCopy<T, D, EXACT>(q_ss, dh).issue(Qs, qb + q0 * q_ss, S - q0);
  cp_async_commit();
  for (int j = 0; j < MMA_SLOTS - 1; ++j) issue(kt_lo + j);
  cp_async_wait<MMA_SLOTS - 1>();
  __syncthreads();
  uint32_t qa[KS][4];                   // this warp's 16 query rows, all of D
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint32_t* base = Qs + (warp * 16 + g) * WS + ks * 8 + t;
    qa[ks][0] = base[0];
    qa[ks][1] = base[8 * WS];
    qa[ks][2] = base[4];
    qa[ks][3] = base[8 * WS + 4];
  }

  // rows r0 = g and r1 = g + 8 of the warp's 16, from rw = its first; m in
  // log2 units
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float acc[DB][4];
#pragma unroll
  for (int d = 0; d < DB; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[d][c] = 0.f;
  const int rw = q0 + warp * 16;
  const int r0 = rw + g, r1 = r0 + 8;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BN;
    cp_async_wait<MMA_SLOTS - 2>();     // getfin: this thread's copies of kt
    __syncthreads();    // tile kt landed for all; kt - 1 is read
    issue(kt + MMA_SLOTS - 1);          // into the slot kt - 1 was read from
    const uint32_t* Ks = smem + ((kt - kt_lo) % MMA_SLOTS) * 2 * TILE;
    const uint32_t* Vs = Ks + TILE;
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t* kp = Ks + (n * 8 + g) * WS + ks * 8 + t;
        mma_16816<T>(s[n], qa[ks], kp[0], kp[4]);
      }
    }

    // mask only where the tile straddles S, the diagonal or the window
    // edge for the warp's rows: c0, c1 belong to row r0, c2, c3 to r1
    const bool straddles = k0 + BN > S || (causal && k0 + BN - 1 > rw) ||
                           (window > 0 && k0 <= rw + 15 - window);
    if (straddles) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = k0 + n * 8 + 2 * t + (c & 1);
          const int r = (c < 2) ? r0 : r1;
          bool ok = col < S;
          if (causal) ok = ok && (col <= r);
          if (window > 0) ok = ok && (col > r - window);
          if (!ok) s[n][c] = NEG_INF;
        }
    }
    // the row max on the raw logits (the scale is positive); a row's 64
    // logits sit in the 4 lanes of a quad
    float tmax0 = NEG_INF, tmax1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      tmax0 = fmaxf(tmax0, fmaxf(s[n][0], s[n][1]));
      tmax1 = fmaxf(tmax1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, off));
      tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, off));
    }
    // the running max and the old terms' factor alpha, in log2 units
    const float mn0 = fmaxf(m0, tmax0 * scale_log2);
    const float mn1 = fmaxf(m1, tmax1 * scale_log2);
    const float alpha0 = fast_exp2(m0 - mn0), alpha1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // p = 2^(s * scale * log2 e - m): one FFMA and one ex2. A row that has
    // met no key yet has its max at the mask's level: subtract 0 there,
    // so that its masked p are 2^-1e29 = 0 (the wgmma body's rule)
    const float sub0 = mn0 > NO_KEY ? mn0 : 0.f;
    const float sub1 = mn1 > NO_KEY ? mn1 : 0.f;
    float ps0 = 0.f, ps1 = 0.f;
    // P as the A fragments of P V: key blocks 2kk (a0, a1) and 2kk + 1
    // (a2, a3) of k-step kk, rows g (a0, a2) and g + 8 (a1, a3)
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float p0 = fast_exp2(fmaf(s[n][0], scale_log2, -sub0));
      const float p1 = fast_exp2(fmaf(s[n][1], scale_log2, -sub0));
      const float p2 = fast_exp2(fmaf(s[n][2], scale_log2, -sub1));
      const float p3 = fast_exp2(fmaf(s[n][3], scale_log2, -sub1));
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      pa[n / 2][(n & 1) * 2] = pack2<T>(p0, p1);
      pa[n / 2][(n & 1) * 2 + 1] = pack2<T>(p2, p3);
    }
    l0 = l0 * alpha0 + ps0;       // this lane's share of the row sums
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int d = 0; d < DB; ++d) {
      acc[d][0] *= alpha0;
      acc[d][1] *= alpha0;
      acc[d][2] *= alpha1;
      acc[d][3] *= alpha1;
    }

    // acc += P V: the logit fragments of key blocks 2kk, 2kk+1 are the A
    // fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      // lanes 0-7, 8-15, 16-23, 24-31 address the rows of four 8x8
      // blocks: keys +0 / +8 of d-block 2dp, then keys +0 / +8 of d-block
      // 2dp+1 (x2: lanes 0-15 only)
      const uint32_t* vrow =
          Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * WS +
          (lane >> 4) * 4;
      if constexpr (DB == 1) {
        uint32_t vfrag[2];
        ldmatrix_x2_trans(vfrag, vrow);
        mma_16816<T>(acc[0], pa[kk], vfrag[0], vfrag[1]);
      } else {
#pragma unroll
        for (int dp = 0; dp < DB / 2; ++dp) {
          uint32_t vfrag[4];
          ldmatrix_x4_trans(vfrag, vrow + dp * 8);
          mma_16816<T>(acc[2 * dp], pa[kk], vfrag[0], vfrag[1]);
          mma_16816<T>(acc[2 * dp + 1], pa[kk], vfrag[2], vfrag[3]);
        }
      }
    }
    // P V done: the next tile's barrier frees this slot
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  T* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int d = 0; d < DB; ++d) {
    const int col = d * 8 + 2 * t;
    if (!EXACT && col >= dh) break;     // past the head: the next one's
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + r0 * o_ss + col) =
          pack2<T>(acc[d][0] * inv0, acc[d][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + r1 * o_ss + col) =
          pack2<T>(acc[d][2] * inv1, acc[d][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 at D = 64 / 128 / 256 on wgmma, tiles by TMA or by the element
// loader (see the note at the top).
namespace wg {

constexpr int BOX = 64;          // columns a TMA box: one 128-byte swizzle row
constexpr int ROW = BOX * 2;     // bytes of a box row

// The tiles by head size and loader (the note at the top says why): two
// consumer warpgroups of 64 query rows each (BM = 128), K/V tiles of BN =
// 128 keys at D = 64 / 128 and 64 at D = 256. The producer is one warp whose
// lane issues TMA (16-bit rows at D = 64 / 128), or a warpgroup (PWG) that
// lowers its registers with setmaxnreg so that the consumers can raise
// theirs: at D = 256 (O alone is 128 registers a consumer thread), for the
// element loader (ELEM), whose 128 threads copy tiles by element, and for
// fp8 tiles by TMA (TMA8), whose warps 1-3 convert V to f16.
template <int D, bool ELEM, bool F8 = false> struct Cfg {
  static constexpr bool WIDE = D > 128;
  static constexpr bool TMA8 = F8 && !ELEM;       // fp8 tiles by TMA
  static constexpr int CONSUMERS = 2;             // consumer warpgroups
  static constexpr int BM = 64 * CONSUMERS;       // query rows a block
  static constexpr int BN = WIDE ? 64 : 128;      // keys a KV tile
  static constexpr int PRODUCER = CONSUMERS * 4;  // the producer's first warp
  static constexpr bool PWG = WIDE || ELEM || TMA8;   // a producer warpgroup
  static constexpr int THREADS = CONSUMERS * 128 + (PWG ? 128 : 32);
  // registers a thread after the hand-over: a block of 384 threads is
  // allotted 168 a thread (65536 / 384 in steps of 8), which the producer
  // warpgroup's P_REGS and the consumers' C_REGS share
  static constexpr int P_REGS = TMA8 ? 40 : !ELEM ? 24 : WIDE ? 40 : 56;
  static constexpr int C_REGS_ALL = (168 * 384 - 128 * P_REGS) / 256 / 8 * 8;
  static constexpr int C_REGS = C_REGS_ALL > 240 ? 240 : C_REGS_ALL;
  // K/V tile pairs in flight or in use (a third measured no faster, with
  // TMA and with the element loader; fp8 by TMA at D = 128 takes a third)
  static constexpr int STAGES = TMA8 && D == 128 ? 3 : 2;
  static constexpr int BOXES = D / BOX;           // boxes across a row
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int TILE = BN * D * 2;         // one K or one V tile
  // + 1 KB to align the tiles to the 1024-byte swizzle atom
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * TILE;
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
  // TMA8: Q and a ring of K as fp8, in rows of ROW8 bytes (a box each)
  // under the swizzle of that row, as the fp8 wgmma reads them; a ring of
  // fp8 V tiles in unswizzled 64-byte box rows and the ring of f16 V tiles
  // that the producer converts them into (the 16-bit layout, TILE bytes);
  // then the f16 ring's `v_ready` mbarriers
  static constexpr int ROW8 = D < 128 ? D : 128;
  static constexpr int BOXES8 = D / ROW8;
  static constexpr int Q8_BYTES = BM * D;
  static constexpr int TILE8 = BN * D;            // one fp8 K or V tile
  static constexpr int SMEM8 =
      1024 + Q8_BYTES + STAGES * (2 * TILE8 + TILE) + STAGES * 8;
  static_assert(SMEM8 <= 232448, "more shared memory than a block may have");
  static_assert(ROW8 == 64 || ROW8 == 128, "a 64- or 128-byte swizzle row");
};

// Two fp8 values (the low 16 bits of v; e5m2 or e4m3fn) as two f16, exact:
// e5m2 is the high byte of an f16, e4m3fn takes the hardware's cvt.
__device__ __forceinline__ uint32_t fp8x2_to_f16x2(uint32_t v, int e5m2) {
  if (e5m2) return ((v & 0xffu) << 8) | ((v & 0xff00u) << 16);
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)(v & 0xffffu), __NV_E4M3);
  return (uint32_t)h.x | ((uint32_t)h.y << 16);
}

// `boxes` TMA boxes of `rows` rows of 64 fp8 values (64 bytes a row, as TMA
// lands them unswizzled) into the f16 layout TMA gives a 16-bit operand
// (128 bytes a row, under the 128-byte swizzle: 16-byte piece c of row r at
// c ^ (r % 8)), which the wgmma descriptors read: the producer's conversion
// of V (TMA8). Threads `tid` of `nthreads`, 16 values a step: fp8 piece c
// of a row (4 a row) becomes f16 pieces 2c and 2c + 1; a warp reads 512
// consecutive bytes, and the 8 threads of each quarter of its stores hit 8
// different 16-byte bank groups.
template <bool E5>
__device__ __forceinline__ void fp8_tile_to_f16(unsigned char* dst,
                                                const unsigned char* src,
                                                int rows, int boxes, int tid,
                                                int nthreads) {
  for (int i = tid; i < boxes * rows * 4; i += nthreads) {
    const int c = i & 3, line = i >> 2, r = line % rows;
    const uint4 in = *reinterpret_cast<const uint4*>(src + line * 64 + c * 16);
    const uint4 lo = make_uint4(
        fp8x2_to_f16x2(in.x, E5), fp8x2_to_f16x2(in.x >> 16, E5),
        fp8x2_to_f16x2(in.y, E5), fp8x2_to_f16x2(in.y >> 16, E5));
    const uint4 hi = make_uint4(
        fp8x2_to_f16x2(in.z, E5), fp8x2_to_f16x2(in.z >> 16, E5),
        fp8x2_to_f16x2(in.w, E5), fp8x2_to_f16x2(in.w >> 16, E5));
    unsigned char* row = dst + line * 128;
    *reinterpret_cast<uint4*>(row + (((2 * c) ^ (r & 7)) << 4)) = lo;
    *reinterpret_cast<uint4*>(row + (((2 * c + 1) ^ (r & 7)) << 4)) = hi;
  }
}

// The element loader's operands (ELEM): q, k, v, their strides in elements
// (q_sb, q_sh, q_ss, k_sb, ..., v_ss) and the bytes of one load, the widest
// of 8, 4, 2 and 1 that every row start and the row's length allow
// (`elem_src`).
struct ElemSrc {
  const unsigned char* q;
  const unsigned char* k;
  const unsigned char* v;
  long long st[9];
  int width;
};

// The 16-bit tile layout TMA writes with the 128-byte swizzle: a box of 64
// columns after another, 128 bytes a row, and 16-byte piece p (columns 8p
// .. 8p + 7) of row r in slot (p % 8) ^ (r % 8) of its row: this returns
// that slot's byte offset in the row.
__device__ __forceinline__ int swizzle(int p, int r) {
  return ((p & 7) ^ (r & 7)) << 4;
}

// The element loader, rows [row0, row0 + ROWS) of one head's [S, dh]
// operand (`src` at its row 0, `rs` elements a row) into a ROWS x D tile of
// that layout, which is what the wgmma descriptors read. Columns dh .. D-1
// and rows past S are written as zeros (rule (a) of the note at the top).
// A row is cut into units of W (async) or 8 (registers) source bytes; thread
// `tid` of the producer warpgroup takes one column of units, every STEP-th
// row, so the 32 threads of a warp read consecutive bytes and each thread's
// column (its bytes in the head or not, its place in the swizzle) is worked
// out once.
//
// 16-bit rows whose starts and length are multiples of W = 4 or 8 bytes:
// one cp.async of W bytes a unit, straight into place (a source size of 0
// writes zeros), no register held; the caller waits for them
// (`cp_async_wait`) before it publishes the tile.
template <int D, int ROWS, int W>
__device__ __forceinline__ void elem_tile_async(unsigned char* dst,
                                                const unsigned char* src,
                                                long long rs, int row0, int S,
                                                int dh, int tid) {
  constexpr int UPR = D * 2 / W;                  // units a row
  constexpr int STEP = 128 / UPR;                 // rows a round of units
  static_assert(128 % UPR == 0 && ROWS % STEP == 0, "whole rows a round");
  const int byte = tid % UPR * W;                 // in the 16-bit row
  // a unit is all inside the head or all past it (dh * 2 % W == 0)
  const bool col_in = byte < dh * 2;
  const int p = byte >> 4;                        // its 16-byte piece
  const uint32_t base = hopper::smem_u32(dst) + (p >> 3) * ROWS * ROW +
                        (byte & 15);
  const unsigned char* nothing = src + (long long)row0 * rs * 2;
  const unsigned char* from = nothing + (long long)(tid / UPR) * rs * 2 + byte;
  const long long next = (long long)STEP * rs * 2;
#pragma unroll 4
  for (int r = tid / UPR; r < ROWS; r += STEP, from += next) {
    const bool in = col_in && row0 + r < S;
    const uint32_t to = base + r * ROW + swizzle(p, r);
    if constexpr (W == 8)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(to),
                   "l"(in ? from : nothing), "r"(in ? 8 : 0)
                   : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(to),
                   "l"(in ? from : nothing), "r"(in ? 4 : 0)
                   : "memory");
  }
}

// Any other rows (fp8, and 16-bit rows of 2-byte units), through
// registers: a unit is 8 source bytes (8 elements of fp8, 4 of 16 bits)
// read with loads of W bytes, U units a thread at a time, their loads all
// issued before their stores; fp8 is converted to f16 on the way (exact),
// 16 bytes a store.
template <int D, int ROWS, bool F8, int W>
__device__ __forceinline__ void elem_tile(unsigned char* dst,
                                          const unsigned char* src,
                                          long long rs, int row0, int S,
                                          int dh, int e5m2, int tid) {
  constexpr int IT = F8 ? 1 : 2;                  // bytes an element
  constexpr int E = 8 / IT;                       // elements a unit
  constexpr int UPR = D / E;                      // units a row
  constexpr int STEP = 128 / UPR;
  // units a round: 4, 2 at D = 256 (its producer keeps 40 registers), and
  // no more than W, so that 8 or fewer loads are in flight
  constexpr int UMAX = D > 128 ? 2 : 4;
  constexpr int U = W < UMAX ? W : UMAX;
  static_assert(128 % UPR == 0 && ROWS % (STEP * U) == 0, "whole rounds");
  const int c = tid % UPR * E;                    // the unit's first column
  const int n_col = min(E, dh - c) * IT;          // its bytes in the head
  const int p = c * 2 >> 4;                       // its 16-byte piece
  const uint32_t base = hopper::smem_u32(dst) + (p >> 3) * ROWS * ROW +
                        (c * 2 & 15);
  const unsigned char* from =
      src + ((long long)(row0 + tid / UPR) * rs + c) * IT;
  const long long next = (long long)STEP * rs * IT;
  for (int r0 = tid / UPR; r0 < ROWS; r0 += STEP * U) {
    uint32_t w[U][2];
#pragma unroll
    for (int j = 0; j < U; ++j, from += next) {
      const int n = row0 + r0 + j * STEP < S ? n_col : 0;
      w[j][0] = w[j][1] = 0u;
#pragma unroll
      for (int i = 0; i < 8 / W; ++i) {
        if (i * W < n) {
          if constexpr (W == 8) {
            const uint2 x = __ldg(reinterpret_cast<const uint2*>(from));
            w[j][0] = x.x;
            w[j][1] = x.y;
          } else {
            uint32_t x;
            if constexpr (W == 4)
              x = __ldg(reinterpret_cast<const unsigned int*>(from + i * W));
            else if constexpr (W == 2)
              x = __ldg(reinterpret_cast<const unsigned short*>(from + i * W));
            else
              x = __ldg(from + i * W);
            w[j][i * W / 4] |= x << (8 * (i * W % 4));
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int r = r0 + j * STEP;
      const uint32_t to = base + r * ROW + swizzle(p, r);
      if constexpr (F8) {
        const uint4 out = make_uint4(fp8x2_to_f16x2(w[j][0], e5m2),
                                     fp8x2_to_f16x2(w[j][0] >> 16, e5m2),
                                     fp8x2_to_f16x2(w[j][1], e5m2),
                                     fp8x2_to_f16x2(w[j][1] >> 16, e5m2));
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(to),
                     "r"(out.x), "r"(out.y), "r"(out.z), "r"(out.w)
                     : "memory");
      } else {
        asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(to),
                     "r"(w[j][0]), "r"(w[j][1])
                     : "memory");
      }
    }
  }
}

// The accumulator lists of the wgmma statements below: 64 (N = 128) or 32
// (N = 64) fp32 registers of one thread.
#define ACC64_REGS \
  "{%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define ACC64_OUT(d) \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
    "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
    "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
    "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
    "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
    "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
    "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define ACC32_REGS \
  "{%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define ACC32_OUT(d) \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
    "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
    "+f"(d[30]), "+f"(d[31])

// S[64 x N] (+)= A[64 x 16] B[16 x N], N = 128 or 64 keys: A and B from
// shared memory, both K-major; scale_d 0 overwrites S, 1 accumulates.
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
#define WGMMA_SS_128(TY)                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY   \
               " " ACC64_REGS ", %64, %65, p, 1, 1, 0, 0;\n}\n"            \
               : ACC64_OUT(d)                                             \
               : "l"(da), "l"(db), "r"(scale_d))
  if constexpr (Op16<T>::kF16)
    WGMMA_SS_128("f16");
  else
    WGMMA_SS_128("bf16");
#undef WGMMA_SS_128
}

template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
#define WGMMA_SS_64(TY)                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY    \
               " " ACC32_REGS ", %32, %33, p, 1, 1, 0, 0;\n}\n"            \
               : ACC32_OUT(d)                                             \
               : "l"(da), "l"(db), "r"(scale_d))
  if constexpr (Op16<T>::kF16)
    WGMMA_SS_64("f16");
  else
    WGMMA_SS_64("bf16");
#undef WGMMA_SS_64
}

// S[64 x N] (+)= A[64 x 32] B[32 x N] on fp8 (E5: both e5m2, else both
// e4m3), N = 128 or 64 keys: A and B from shared memory, both K-major (fp8
// wgmma takes no other form); products exact, summed in fp32.
template <bool E5>
__device__ __forceinline__ void wgmma_ss8(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
#define WGMMA_SS8_128(TY)                                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n128k32.f32." TY "." TY   \
               " " ACC64_REGS ", %64, %65, p, 1, 1;\n}\n"                  \
               : ACC64_OUT(d)                                             \
               : "l"(da), "l"(db), "r"(scale_d))
  if constexpr (E5)
    WGMMA_SS8_128("e5m2");
  else
    WGMMA_SS8_128("e4m3");
#undef WGMMA_SS8_128
}

template <bool E5>
__device__ __forceinline__ void wgmma_ss8(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
#define WGMMA_SS8_64(TY)                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n64k32.f32." TY "." TY    \
               " " ACC32_REGS ", %32, %33, p, 1, 1;\n}\n"                  \
               : ACC32_OUT(d)                                             \
               : "l"(da), "l"(db), "r"(scale_d))
  if constexpr (E5)
    WGMMA_SS8_64("e5m2");
  else
    WGMMA_SS8_64("e4m3");
#undef WGMMA_SS8_64
}

// The descriptor of a K-major tile that TMA wrote in rows of ROW bytes
// under the swizzle of that row: 128 (`wgmma_desc_sw128`), or 64, whose
// 8-row groups are 512 bytes (layout type 2; the leading field is not read
// for a K-major swizzled operand). A k-step inside a row adds its byte
// offset to `addr`, as for the 128-byte swizzle.
template <int ROW>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  if constexpr (ROW == 128)
    return hopper::wgmma_desc_sw128(addr);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * ROW >> 4) << 32) | ((uint64_t)2 << 62);
}

// O[64 x N] += A[64 x 16] B[16 x N], N = 64 or 128: A from registers (the
// fragment of mma.sync's A, one 16-row slice a warp), B from shared memory
// MN-major (transposed: N within the row, 64 columns a swizzle atom, the
// atoms `lbo` bytes apart in the descriptor).
template <typename T>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
#define WGMMA_RS_128(TY)                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY   \
               " " ACC64_REGS ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
               : ACC64_OUT(d)                                             \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  if constexpr (Op16<T>::kF16)
    WGMMA_RS_128("f16");
  else
    WGMMA_RS_128("bf16");
#undef WGMMA_RS_128
}

template <typename T>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
#define WGMMA_RS_64(TY)                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY    \
               " " ACC32_REGS ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
               : ACC32_OUT(d)                                             \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  if constexpr (Op16<T>::kF16)
    WGMMA_RS_64("f16");
  else
    WGMMA_RS_64("bf16");
#undef WGMMA_RS_64
}

// O += P V for one 16-key step of a V tile whose 64-column boxes lie
// `box_bytes` apart, starting at `v_addr`: up to D = 128 one instruction of
// N = D spans the boxes; at D = 256 (N = 256 would hold all 128 accumulators
// in one asm statement) one m64n64k16 a box, whose accumulators are
// oacc[32x .. 32x + 31], the same layout as columns 64x .. 64x + 63 of one
// N = 256 instruction.
template <typename T, int D>
__device__ __forceinline__ void wgmma_pv(float (&oacc)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint32_t v_addr, uint32_t box_bytes) {
  if constexpr (D <= 128) {
    wgmma_rs_tb<T>(oacc, a, hopper::wgmma_desc_sw128(v_addr, box_bytes));
  } else {
#pragma unroll
    for (int x = 0; x < D / BOX; ++x)
      wgmma_rs_tb<T>(*reinterpret_cast<float(*)[32]>(&oacc[32 * x]), a,
                     hopper::wgmma_desc_sw128(v_addr + x * box_bytes));
  }
}

// One TMA box: `pos` packs the places (1..3) of the S, H and B dimensions in
// the map, which orders them by stride (`flash_map`).
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int pos, int col,
                                         int row, int head, int batch) {
  auto at = [&](int place) {
    return place == (pos & 3) ? row : place == ((pos >> 2) & 3) ? head : batch;
  };
  hopper::tma_load_4d(dst, map, bar, col, at(1), at(2), at(3));
}

}  // namespace wg

// F8: q, k, v and o are fp8 (e5m2 when `e5m2`, else e4m3fn), T = __half.
// ELEM: the producer warpgroup copies the tiles by element (`elem_tile`:
// rows of no whole 16-byte pieces, which TMA cannot load; fp8 converted to
// f16 as it is loaded) and the consumers run the 16-bit code. F8 without
// ELEM (TMA8): TMA lands Q, K and V as fp8, the consumers compute Q K^T on
// the fp8 wgmma of the kind E5 (e5m2, else e4m3; `e5m2` is E5), and the
// producer warpgroup converts V to f16 for the f16 P V. With F8 the output
// is rounded to fp8.
template <typename T, int D, bool EXACT, bool F8 = false, bool ELEM = false,
          bool E5 = false>
__global__ void __launch_bounds__(wg::Cfg<D, ELEM, F8>::THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ wg::ElemSrc src,
                   T* __restrict__ o, int S, int group,
                   int causal, int window, float scale_log2, int dh, int q_pos,
                   int k_pos, int v_pos, long long o_sb, long long o_sh,
                   long long o_ss, int e5m2) {
  using namespace hopper;
  using wg::load_box;
  using wg::wgmma_ss;
  using C = wg::Cfg<D, ELEM, F8>;
  static_assert(!ELEM || !EXACT, "the element loader runs padded heads only");
  // this head size's tiles, shadowing the 64-row tiles of the other bodies
  constexpr int BM = C::BM, BN = C::BN, STAGES = C::STAGES;
  constexpr int CONSUMERS = C::CONSUMERS, BOX = wg::BOX, ROW = wg::ROW;
  constexpr bool TMA8 = C::TMA8;                  // fp8 tiles by TMA
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[STAGES], empty[STAGES];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  unsigned char* Qs = smem_raw + pad;             // [BOXES][BM][64] swizzled
  unsigned char* KV = Qs + C::Q_BYTES;            // stage s: K then V tile
  // TMA8: Q8 [BOXES8][BM][ROW8] and the K8 ring, swizzled; the V8 ring
  // [D / 64][BN][64]; the f16 V ring; v_ready[s], the f16 V of stage s
  // converted (the producer's warps 1-3 arrive)
  unsigned char* Q8 = smem_raw + pad;
  unsigned char* K8 = Q8 + C::Q8_BYTES;
  unsigned char* V8 = K8 + STAGES * C::TILE8;
  unsigned char* V16 = V8 + STAGES * C::TILE8;
  uint64_t* v_ready = reinterpret_cast<uint64_t*>(V16 + STAGES * C::TILE);
  constexpr int NC = CONSUMERS * 128;             // consumer threads
  constexpr int CONVERTERS = 96;                  // TMA8: V's converters

  // the query tile is the slowest grid dimension, counted down: every
  // (head, batch) block of the heaviest tile is dispatched before any of
  // the next, so the light tiles fill the last wave
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / group;
  const int q0 = qt * BM;
  const int nkt = (S + BN - 1) / BN;
  const int q_last = min(q0 + BM, S) - 1;
  const int kt_hi = causal ? min(nkt, q_last / BN + 1) : nkt;
  int kt_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / BN;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    // a stage is full when its copies have delivered their bytes (TMA) or
    // when each thread of the element loader has arrived
    constexpr uint32_t FILLERS = ELEM ? 128 : 1;
    mbar_init(&q_full, FILLERS);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], FILLERS);
      mbar_init(&empty[s], CONSUMERS * 4);        // one arrival a warp
      if constexpr (TMA8) mbar_init(&v_ready[s], CONVERTERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= C::PRODUCER) {                      // aload
    if constexpr (C::PWG) setmaxnreg_dec<C::P_REGS>();
    if constexpr (ELEM) {
      // every thread of the warpgroup copies its share of a tile, makes its
      // stores visible to the tensor cores' (async) proxy and arrives
      const int tid = threadIdx.x - NC;
      constexpr int IT = F8 ? 1 : 2;
      const long long* st = src.st;
      const unsigned char* qb = src.q + (b * st[0] + h * st[1]) * IT;
      const unsigned char* kb = src.k + (b * st[3] + hk * st[4]) * IT;
      const unsigned char* vb = src.v + (b * st[6] + hk * st[7]) * IT;
      // one tile: cp.async for 16-bit rows of 4- or 8-byte units (waited
      // for before the tile is published), else through registers
      auto tile = [&](auto width, auto rows, unsigned char* dst,
                      const unsigned char* from, long long rs, int row0) {
        constexpr int W = decltype(width)::value, R = decltype(rows)::value;
        if constexpr (!F8 && W >= 4)
          wg::elem_tile_async<D, R, W>(dst, from, rs, row0, S, dh, tid);
        else
          wg::elem_tile<D, R, F8, W>(dst, from, rs, row0, S, dh, e5m2, tid);
      };
      auto produce = [&](auto width) {
        using QR = std::integral_constant<int, BM>;
        using KR = std::integral_constant<int, BN>;
        tile(width, QR{}, Qs, qb, st[2], q0);
        cp_async_commit();
        bool q_open = true;           // q_full not yet arrived on
        auto publish = [&](uint64_t* bar) {
          fence_proxy_async();        // the stores, before wgmma reads them
          mbar_arrive(bar);
        };
        for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
          const int s = i % STAGES;
          mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);   // the slot is free
          unsigned char* ks = KV + s * 2 * C::TILE;
          tile(width, KR{}, ks, kb, st[5], kt * BN);
          tile(width, KR{}, ks + C::TILE, vb, st[8], kt * BN);
          cp_async_commit();
          if (q_open) {               // Q first, under the first K/V copies
            cp_async_wait<1>();
            publish(&q_full);
            q_open = false;
          }
          cp_async_wait<0>();
          publish(&full[s]);
        }
        if (q_open) {                 // no K/V tile (not reached: kt_lo < kt_hi)
          cp_async_wait<0>();
          publish(&q_full);
        }
      };
      if constexpr (F8) {
        if (src.width == 8)
          produce(std::integral_constant<int, 8>{});
        else if (src.width == 4)
          produce(std::integral_constant<int, 4>{});
        else if (src.width == 2)
          produce(std::integral_constant<int, 2>{});
        else
          produce(std::integral_constant<int, 1>{});
      } else {
        if (src.width == 8)
          produce(std::integral_constant<int, 8>{});
        else if (src.width == 4)
          produce(std::integral_constant<int, 4>{});
        else
          produce(std::integral_constant<int, 2>{});
      }
    } else if constexpr (TMA8) {
      constexpr int ROW8 = C::ROW8, TILE8 = C::TILE8;
      if (warp == C::PRODUCER) {                  // TMA, one lane
        if (lane == 0) {
          mbar_arrive_expect_tx(&q_full, C::Q8_BYTES);
#pragma unroll
          for (int x = 0; x < C::BOXES8; ++x)
            load_box(Q8 + x * BM * ROW8, &tq, &q_full, q_pos, x * ROW8, q0,
                     h, b);
          for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
            const int s = i % STAGES;
            mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);   // the slot is free
            mbar_arrive_expect_tx(&full[s], 2 * TILE8);
#pragma unroll
            for (int x = 0; x < C::BOXES8; ++x)
              load_box(K8 + s * TILE8 + x * BN * ROW8, &tk, &full[s], k_pos,
                       x * ROW8, kt * BN, hk, b);
#pragma unroll
            for (int x = 0; x < C::BOXES; ++x)
              load_box(V8 + s * TILE8 + x * BN * BOX, &tv, &full[s], v_pos,
                       x * BOX, kt * BN, hk, b);
          }
        }
      } else {      // warps 1-3: each landed fp8 V tile into the f16 ring
        const int tid = threadIdx.x - NC - 32;
        for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
          const int s = i % STAGES;
          // the f16 slot is free too: TMA refilled stage s only after every
          // consumer warp was done with its last tile
          mbar_wait(&full[s], (i / STAGES) & 1);
          wg::fp8_tile_to_f16<E5>(V16 + s * C::TILE, V8 + s * TILE8, BN,
                                  C::BOXES, tid, CONVERTERS);
          fence_proxy_async();                    // before wgmma reads it
          mbar_arrive(&v_ready[s]);
        }
      }
    } else if (warp == C::PRODUCER && lane == 0) {      // TMA, one lane
      mbar_arrive_expect_tx(&q_full, C::Q_BYTES);
#pragma unroll
      for (int x = 0; x < C::BOXES; ++x)
        load_box(Qs + x * BM * ROW, &tq, &q_full, q_pos, x * BOX, q0, h, b);
      for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);   // the slot is free
        mbar_arrive_expect_tx(&full[s], 2 * C::TILE);
        unsigned char* ks = KV + s * 2 * C::TILE;
#pragma unroll
        for (int x = 0; x < C::BOXES; ++x) {
          load_box(ks + x * BN * ROW, &tk, &full[s], k_pos, x * BOX,
                   kt * BN, hk, b);
          load_box(ks + C::TILE + x * BN * ROW, &tv, &full[s], v_pos,
                   x * BOX, kt * BN, hk, b);
        }
      }
    }
    return;
  }
  if constexpr (C::PWG) setmaxnreg_inc<C::C_REGS>();

  // consumers: warpgroup wgi owns rows rlo .. rlo + 63 of the tile; in the
  // accumulators (the mma.sync C layout, one 16-row slice a warp) this
  // thread holds rows r0 = g and r1 = g + 8 of its warp's slice, columns
  // 8j + 2t and 8j + 2t + 1 of every 8-column block j
  const int wgi = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int rlo = q0 + wgi * 64;
  const int r0 = rlo + (warp & 3) * 16 + g, r1 = r0 + 8;
  const uint32_t q_addr = smem_u32(Qs) + wgi * 64 * ROW;

  float oacc[D / 2];                              // O: 64 x D a warpgroup
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // log2 units

  mbar_wait(&q_full, 0);
  for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
    const int s = i % STAGES;
    const int k0 = kt * BN;
    // a tile every key of which is masked for all 64 rows is skipped
    const bool dead = (causal && k0 > rlo + 63) ||
                      (window > 0 && k0 + BN - 1 <= rlo - window);
    if constexpr (TMA8) {     // getfin: the converters saw K and V land
      if (!dead) mbar_wait(&v_ready[s], (i / STAGES) & 1);
    } else {
      mbar_wait(&full[s], (i / STAGES) & 1);      // getfin
    }
    if (!dead) {
      const uint32_t k_addr = smem_u32(KV + s * 2 * C::TILE);
      const uint32_t v_addr =
          TMA8 ? smem_u32(V16 + s * C::TILE) : k_addr + C::TILE;

      float sacc[BN / 2];
      wgmma_fence();
      if constexpr (TMA8) {
        // S = Q K^T on fp8: D / 32 k-steps of 32 bytes, ROW8 / 32 in each
        // box row. The tensor core keeps fewer bits than fp32 while it sums
        // a chain of k-steps into its accumulator, so a chain is at most
        // CHAIN k-steps: the first goes to sacc, each other to sacc2, which
        // is added to sacc in fp32 once it is done
        constexpr int ROW8 = C::ROW8, KPR = ROW8 / 32, KS = D / 32;
        constexpr int CHAIN = 2, CHAINS = (KS + CHAIN - 1) / CHAIN;
        const uint32_t q8 = smem_u32(Q8) + wgi * 64 * ROW8;
        const uint32_t k8 = smem_u32(K8 + s * C::TILE8);
        auto chain = [&](float (&acc)[BN / 2], int c) {
#pragma unroll
          for (int ks = c * CHAIN; ks < KS && ks < (c + 1) * CHAIN; ++ks) {
            const uint32_t off = (ks % KPR) * 32;
            wg::wgmma_ss8<E5>(
                acc,
                wg::desc_k_major<ROW8>(q8 + (ks / KPR) * BM * ROW8 + off),
                wg::desc_k_major<ROW8>(k8 + (ks / KPR) * BN * ROW8 + off),
                ks > c * CHAIN);
          }
        };
        chain(sacc, 0);
        if constexpr (CHAINS > 1) {
          float sacc2[BN / 2];
#pragma unroll
          for (int c = 1; c < CHAINS; ++c) {
            chain(sacc2, c);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(sacc);
            fence_regs(sacc2);
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) sacc[i] += sacc2[i];
            if (c + 1 < CHAINS) wgmma_fence();    // sacc2 is read: reuse it
          }
        }
      } else {
        // S = Q K^T: D / 16 k-steps, 4 in each 64-column box
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t off = (ks % 4) * 32;   // 16 columns, 32 bytes
          wgmma_ss<T>(
              sacc, wgmma_desc_sw128(q_addr + (ks / 4) * BM * ROW + off),
              wgmma_desc_sw128(k_addr + (ks / 4) * BN * ROW + off), ks > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);

      // mask only where the tile straddles S, the diagonal or the window
      // edge; the max is taken on the raw logits (the scale is positive),
      // then p = 2^(s * scale * log2 e - m) is one FFMA and one ex2
      const bool edge = k0 + BN > S || (causal && k0 + BN - 1 > rlo) ||
                        (window > 0 && k0 <= rlo + 63 - window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = k0 + 8 * j + 2 * t + (c & 1);
            const int r = c < 2 ? r0 : r1;
            bool ok = col < S;
            if (causal) ok = ok && col <= r;
            if (window > 0) ok = ok && col > r - window;
            if (!ok) sacc[4 * j + c] = NEG_INF;
          }
      }
      float tmax0 = NEG_INF, tmax1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        tmax0 = fmaxf(tmax0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        tmax1 = fmaxf(tmax1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {     // a row lives in a quad
        tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, off));
        tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, off));
      }
      const float mn0 = fmaxf(m0, tmax0 * scale_log2);
      const float mn1 = fmaxf(m1, tmax1 * scale_log2);
      const float alpha0 = fast_exp2(m0 - mn0), alpha1 = fast_exp2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      // A row that has met no key yet has its max at the mask's level, where
      // the FFMA's unrounded product and the rounded max differ by ~1e22:
      // subtract 0 there, so that its masked p are 2^-1e29 = 0, not 2^1e22.
      const float sub0 = mn0 > NO_KEY ? mn0 : 0.f;
      const float sub1 = mn1 > NO_KEY ? mn1 : 0.f;
      float ps0 = 0.f, ps1 = 0.f;
      uint32_t pa[BN / 16][4];                    // P as wgmma's A fragments
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float p0 = fast_exp2(fmaf(sacc[4 * j], scale_log2, -sub0));
        const float p1 = fast_exp2(fmaf(sacc[4 * j + 1], scale_log2, -sub0));
        const float p2 = fast_exp2(fmaf(sacc[4 * j + 2], scale_log2, -sub1));
        const float p3 = fast_exp2(fmaf(sacc[4 * j + 3], scale_log2, -sub1));
        ps0 += p0 + p1;
        ps1 += p2 + p3;
        // keys 16kk .. 16kk+15 are column blocks 2kk (a0, a1) and 2kk+1
        // (a2, a3), rows g (a0, a2) and g + 8 (a1, a3)
        pa[j / 2][(j & 1) * 2] = pack2<T>(p0, p1);
        pa[j / 2][(j & 1) * 2 + 1] = pack2<T>(p2, p3);
      }
      l0 = l0 * alpha0 + ps0;                     // this lane's share
      l1 = l1 * alpha1 + ps1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        oacc[4 * j] *= alpha0;
        oacc[4 * j + 1] *= alpha0;
        oacc[4 * j + 2] *= alpha1;
        oacc[4 * j + 3] *= alpha1;
      }

      // O += P V: BN / 16 k-steps of 16 keys (2048 bytes of each V box),
      // the boxes BN * ROW bytes apart
      fence_regs(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wg::wgmma_pv<T, D>(oacc, pa[kk], v_addr + kk * 16 * ROW, BN * ROW);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(oacc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);        // this warp is done with s
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  T* ob = o + b * o_sb + h * o_sh;
  // F8: o is fp8, its strides in bytes
  unsigned char* ob8 = reinterpret_cast<unsigned char*>(o) + b * o_sb +
                       h * o_sh;
  const __nv_fp8_interpretation_t kind = e5m2 ? __NV_E5M2 : __NV_E4M3;
  // one output value of row r, column col
  auto put = [&](int r, int col, float x) {
    if constexpr (F8)
      ob8[r * o_ss + col] = to_fp8(x, kind);
    else
      ob[r * o_ss + col] = from_float<T>(x);
  };
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (!EXACT && col >= dh) break;     // columns dh.. are another head's
    if constexpr (ELEM) {     // rows start at any element: one value a store
      const bool pair = col + 1 < dh;
      if (r0 < S) {
        put(r0, col, oacc[4 * j] * inv0);
        if (pair) put(r0, col + 1, oacc[4 * j + 1] * inv0);
      }
      if (r1 < S) {
        put(r1, col, oacc[4 * j + 2] * inv1);
        if (pair) put(r1, col + 1, oacc[4 * j + 3] * inv1);
      }
    } else if constexpr (F8) {          // two values a 2-byte store
      if (r0 < S)
        *reinterpret_cast<uint16_t*>(ob8 + r0 * o_ss + col) =
            (uint16_t)(to_fp8(oacc[4 * j] * inv0, kind) |
                       (to_fp8(oacc[4 * j + 1] * inv0, kind) << 8));
      if (r1 < S)
        *reinterpret_cast<uint16_t*>(ob8 + r1 * o_ss + col) =
            (uint16_t)(to_fp8(oacc[4 * j + 2] * inv1, kind) |
                       (to_fp8(oacc[4 * j + 3] * inv1, kind) << 8));
    } else {
      if (r0 < S)
        *reinterpret_cast<uint32_t*>(ob + r0 * o_ss + col) =
            pack2<T>(oacc[4 * j] * inv0, oacc[4 * j + 1] * inv0);
      if (r1 < S)
        *reinterpret_cast<uint32_t*>(ob + r1 * o_ss + col) =
            pack2<T>(oacc[4 * j + 2] * inv1, oacc[4 * j + 3] * inv1);
    }
  }
}

// The wgmma body above 256 columns (16-bit rows of whole 16-byte pieces,
// D > 256): one block a 64-row query tile of a head, as at D = 256, with
// two consumer warpgroups that split the head's columns between them where
// the D = 256 body splits its rows. Up to 512 (Dp 512) a block takes the
// whole head; above, a chunk of 512 output columns [c0, c0 + 512), one
// block a chunk (STREAM). Warpgroup w owns output columns [c0 + 256 w, c0 +
// 256 w + 256), and its 64 x 256 fp32 O is 128 registers a thread, as at D
// = 256:
//   - S = Q K^T is the sum of the two warpgroups' partial products: up to
//     512 over their own 256 columns of Q and K (16 k-steps of m64n64k16
//     each), above over their halves of the head's 64-column pieces. Each
//     writes its 64 x 64 fp32 partial to its half of `xch` (16 KB, a
//     thread's 32 values as 8 float4 in [j][thread] order, so a warp's
//     stores are consecutive), the two meet at a named barrier, each adds
//     the other's partial to its own (fp32 addition commutes, so both hold
//     the same S bit for bit) and a second barrier frees the buffers. Both
//     then run the same mask and softmax, and their own P V on their own
//     256 V columns. So Q K^T is done once a tile up to 512 and once a
//     512-column chunk above, where the chunked body of 256-column blocks
//     did it once a 256-column chunk (at D = 2048 half the operations);
//   - up to 512, Q (64 KB) is loaded once, and K and V come a warpgroup's
//     half-tile at a time (64 keys x 256 columns, 32 KB) into that
//     warpgroup's own K slot and V slot, each freed on its own (`k_full` /
//     `k_empty` stage 0, `v_full` / `v_empty`), so the next tile's K lands
//     under this tile's softmax and P V, and the next V under the next Q
//     K^T. 64 KB of Q, four 32 KB slots and the 32 KB exchange are 225 KB:
//     no second stage fits;
//   - above 512 (STREAM), Q and K stream through a ring a warpgroup of
//     QK_STAGES stages of one 64-column piece of each (16 KB), in the 128
//     KB that Q and the K slots take below; a warpgroup keeps one piece's
//     wgmma group in flight and frees a stage when the group after it is
//     issued (wgmma.wait_group 1);
//   - one producer warpgroup (one lane issues TMA) hands its registers to
//     the consumers with setmaxnreg (24 / 240), as at D = 256;
//   - rules (a)-(c) hold: zeros past D (TMA's fill, also of boxes wholly
//     past it: skipping them made the wgmma loops' trip counts depend on D,
//     which ptxas serializes), stores of columns < D, the scale of the
//     whole head.
namespace wg {
struct Pair {
  static constexpr int BM = 64, BN = 64;          // query rows, keys a tile
  static constexpr int CONSUMERS = 2;             // a warpgroup a column half
  static constexpr int THREADS = CONSUMERS * 128 + 128;
  static constexpr int PRODUCER = CONSUMERS * 4;  // the producer's first warp
  static constexpr int P_REGS = 24, C_REGS = 240;
  static constexpr int PIECE = 64 * ROW;          // one 64 x 64 box
  static constexpr int HALF = (WIDE_DC / BOX) * PIECE;   // 64 x 256
  static constexpr int QK_STAGES = 4;             // STREAM: a warpgroup's ring
  static constexpr int XCH = 64 * 64 * 4;         // a warpgroup's partial S
  static constexpr int SMEM = 1024 + 2 * HALF     // Q (STREAM: the rings)
                              + 4 * HALF          // K and V slots
                              + 2 * XCH;
  static_assert(2 * QK_STAGES * 2 * PIECE == 4 * HALF,
                "the rings take the place of Q and the K slots");
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};
}  // namespace wg

template <typename T, bool STREAM>
__global__ void __launch_bounds__(wg::Pair::THREADS, 1)
flash_wgmma_pair_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        T* __restrict__ o, int S, int group, int causal,
                        int window, float scale_log2, int dh, int chunks,
                        int q_pos, int k_pos, int v_pos, long long o_sb,
                        long long o_sh, long long o_ss) {
  using namespace hopper;
  using wg::load_box;
  using wg::wgmma_ss;
  using P = wg::Pair;
  constexpr int BM = P::BM, BN = P::BN, BOX = wg::BOX, ROW = wg::ROW;
  constexpr int NB = WIDE_DC / BOX;               // boxes a half row
  constexpr int SQ = STREAM ? P::QK_STAGES : 1;   // K (and Q) stages
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[2][SQ], k_empty[2][SQ],
      v_full[2], v_empty[2];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  unsigned char* Qs = smem_raw + pad;             // half w: [NB][BM][64]
  unsigned char* Ks = Qs + 2 * P::HALF;           // warpgroup w's K slot
  unsigned char* QK = Qs;   // STREAM: ring w, stage s: a Q box, a K box
  unsigned char* Vs = Ks + 2 * P::HALF;           // warpgroup w's V slot
  float4* xch = reinterpret_cast<float4*>(Vs + 2 * P::HALF);

  const int qt = gridDim.z - 1 - blockIdx.z;      // heaviest tiles first
  const int h = blockIdx.x / chunks, b = blockIdx.y;
  const int c0 = (blockIdx.x % chunks) * 2 * WIDE_DC;   // the block's chunk
  const int hk = h / group;
  const int q0 = qt * BM;
  const int nkt = (S + BN - 1) / BN;
  const int q_last = min(q0 + BM, S) - 1;
  const int kt_hi = causal ? min(nkt, q_last / BN + 1) : nkt;
  int kt_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / BN;
  // STREAM: the head's 64-column pieces, the first `split` warpgroup 0's
  const int pieces = (dh + BOX - 1) / BOX, split = (pieces + 1) / 2;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
#pragma unroll
    for (int w = 0; w < 2; ++w) {
#pragma unroll
      for (int s = 0; s < SQ; ++s) {
        mbar_init(&k_full[w][s], 1);
        mbar_init(&k_empty[w][s], 4);             // one arrival a warp
      }
      mbar_init(&v_full[w], 1);
      mbar_init(&v_empty[w], 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= P::PRODUCER) {                      // aload, one lane
    setmaxnreg_dec<P::P_REGS>();
    if (warp == P::PRODUCER && lane == 0) {
      if constexpr (!STREAM) {
        mbar_arrive_expect_tx(&q_full, 2 * P::HALF);
        for (int w = 0; w < 2; ++w)
          for (int x = 0; x < NB; ++x)
            load_box(Qs + w * P::HALF + x * P::PIECE, &tq, &q_full, q_pos,
                     w * WIDE_DC + x * BOX, q0, h, b);
      }
      // a warpgroup's half-tile of K (kv 0) or V (kv 1) into its slot
      auto half = [&](int kv, int w, int i, int kt) {
        uint64_t* empty = kv ? &v_empty[w] : &k_empty[w][0];
        uint64_t* full = kv ? &v_full[w] : &k_full[w][0];
        unsigned char* dst = (kv ? Vs : Ks) + w * P::HALF;
        mbar_wait(empty, (i & 1) ^ 1);            // the slot is free
        mbar_arrive_expect_tx(full, P::HALF);
        for (int x = 0; x < NB; ++x)
          load_box(dst + x * P::PIECE, kv ? &tv : &tk, full, kv ? v_pos : k_pos,
                   c0 * kv + w * WIDE_DC + x * BOX, kt * BN, hk, b);
      };
      int n0 = 0, n1 = 0;                         // STREAM: stages issued
      for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
        if constexpr (STREAM) {   // the pieces of both warpgroups in turn
          for (int j = 0; j < split; ++j) {
#pragma unroll
            for (int w = 0; w < 2; ++w) {
              if (j >= (w ? pieces - split : split)) continue;
              int& n = w ? n1 : n0;
              const int s = n % SQ, p = (w ? split : 0) + j;
              mbar_wait(&k_empty[w][s], ((n / SQ) & 1) ^ 1);
              mbar_arrive_expect_tx(&k_full[w][s], 2 * P::PIECE);
              unsigned char* st = QK + (w * SQ + s) * 2 * P::PIECE;
              load_box(st, &tq, &k_full[w][s], q_pos, p * BOX, q0, h, b);
              load_box(st + P::PIECE, &tk, &k_full[w][s], k_pos, p * BOX,
                       kt * BN, hk, b);
              ++n;
            }
          }
        } else {
          half(0, 0, i, kt);
          half(0, 1, i, kt);
        }
        half(1, 0, i, kt);
        half(1, 1, i, kt);
      }
    }
    return;
  }
  setmaxnreg_inc<P::C_REGS>();

  // consumers: warpgroup w, columns c0 + 256 w ..; this thread rows r0, r1
  // of its warp's 16 (the accumulator layout of the D = 256 body)
  const int w = warp >> 2, tw = threadIdx.x & 127;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + (warp & 3) * 16 + g, r1 = r0 + 8;
  const uint32_t q_addr = smem_u32(Qs + w * P::HALF);
  const uint32_t k_addr = smem_u32(Ks + w * P::HALF);
  const uint32_t v_addr = smem_u32(Vs + w * P::HALF);
  const int my_pieces = w ? pieces - split : split;   // STREAM
  float4* const x_mine = xch + w * 8 * 128 + tw;
  const float4* const x_other = xch + (1 - w) * 8 * 128 + tw;
  float oacc[WIDE_DC / 2];                        // O: 64 x 256 a warpgroup
#pragma unroll
  for (int i = 0; i < WIDE_DC / 2; ++i) oacc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // log2 units

  if constexpr (!STREAM) mbar_wait(&q_full, 0);
  int nq = 0;                                     // STREAM: stages taken
  for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
    const int k0 = kt * BN;
    // a tile every key of which is masked for all 64 rows is skipped by both
    const bool dead = (causal && k0 > q0 + 63) ||
                      (window > 0 && k0 + BN + window <= q0 + 1);
    float sacc[BN / 2];
    // a stage's slot is free: each warp arrives once
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&k_empty[w][s]);
    };
    if constexpr (STREAM) {
      if (dead) {
        for (int j = 0; j < my_pieces; ++j, ++nq) {
          mbar_wait(&k_full[w][nq % SQ], (nq / SQ) & 1);
          release(nq % SQ);
        }
      } else {
        // this warpgroup's part of S over its pieces, a stage each, one
        // piece's group in flight: a stage is freed once the group after
        // it is issued and it has completed
        wgmma_fence();
        for (int j = 0; j < my_pieces; ++j, ++nq) {
          const int s = nq % SQ;
          mbar_wait(&k_full[w][s], (nq / SQ) & 1);  // getfin
          const uint32_t qa = smem_u32(QK + (w * SQ + s) * 2 * P::PIECE);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)          // 16 columns, 32 bytes
            wgmma_ss<T>(sacc, wgmma_desc_sw128(qa + ks * 32),
                        wgmma_desc_sw128(qa + P::PIECE + ks * 32),
                        j > 0 || ks > 0);
          wgmma_commit();
          wgmma_wait<1>();
          if (j > 0) release((nq - 1) % SQ);
        }
        wgmma_wait<0>();
        fence_regs(sacc);
        release((nq - 1) % SQ);
      }
    } else {
      mbar_wait(&k_full[w][0], i & 1);            // getfin
      if (!dead) {
        // this warpgroup's part of S: its columns' k-steps, 4 a box
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4 * NB; ++ks) {
          const uint32_t off = (ks / 4) * P::PIECE + (ks % 4) * 32;
          wgmma_ss<T>(sacc, wgmma_desc_sw128(q_addr + off),
                      wgmma_desc_sw128(k_addr + off), ks > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);
      }
      release(0);                                 // K's slot is free
    }
    if (!dead) {
      // the two partials meet: S = own + other's, the same in both
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        x_mine[j * 128] = make_float4(sacc[4 * j], sacc[4 * j + 1],
                                      sacc[4 * j + 2], sacc[4 * j + 3]);
      asm volatile("bar.sync 1, %0;\n" ::"n"(2 * 128) : "memory");
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float4 x = x_other[j * 128];
        sacc[4 * j] += x.x;
        sacc[4 * j + 1] += x.y;
        sacc[4 * j + 2] += x.z;
        sacc[4 * j + 3] += x.w;
      }
      asm volatile("bar.sync 2, %0;\n" ::"n"(2 * 128) : "memory");

      // masks where the tile straddles S, the diagonal or the window edge
      const bool edge = k0 + BN > S || (causal && k0 + BN - 1 > q0) ||
                        (window > 0 && k0 + window <= q0 + 63);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = k0 + 8 * j + 2 * t + (c & 1);
            const int r = c < 2 ? r0 : r1;
            bool ok = col < S;
            if (causal) ok = ok && col <= r;
            if (window > 0) ok = ok && col > r - window;
            if (!ok) sacc[4 * j + c] = NEG_INF;
          }
      }
      float tmax0 = NEG_INF, tmax1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        tmax0 = fmaxf(tmax0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        tmax1 = fmaxf(tmax1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, off));
        tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, off));
      }
      const float mn0 = fmaxf(m0, tmax0 * scale_log2);
      const float mn1 = fmaxf(m1, tmax1 * scale_log2);
      const float alpha0 = fast_exp2(m0 - mn0), alpha1 = fast_exp2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      // a row that has met no key yet subtracts 0 (see the D = 256 body)
      const float sub0 = mn0 > NO_KEY ? mn0 : 0.f;
      const float sub1 = mn1 > NO_KEY ? mn1 : 0.f;
      float ps0 = 0.f, ps1 = 0.f;
      uint32_t pa[BN / 16][4];                    // P as wgmma's A fragments
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float p0 = fast_exp2(fmaf(sacc[4 * j], scale_log2, -sub0));
        const float p1 = fast_exp2(fmaf(sacc[4 * j + 1], scale_log2, -sub0));
        const float p2 = fast_exp2(fmaf(sacc[4 * j + 2], scale_log2, -sub1));
        const float p3 = fast_exp2(fmaf(sacc[4 * j + 3], scale_log2, -sub1));
        ps0 += p0 + p1;
        ps1 += p2 + p3;
        pa[j / 2][(j & 1) * 2] = pack2<T>(p0, p1);
        pa[j / 2][(j & 1) * 2 + 1] = pack2<T>(p2, p3);
      }
      l0 = l0 * alpha0 + ps0;
      l1 = l1 * alpha1 + ps1;
#pragma unroll
      for (int j = 0; j < WIDE_DC / 8; ++j) {
        oacc[4 * j] *= alpha0;
        oacc[4 * j + 1] *= alpha0;
        oacc[4 * j + 2] *= alpha1;
        oacc[4 * j + 3] *= alpha1;
      }
      // O += P V over this warpgroup's columns: four 16-key steps of its
      // four V boxes, PIECE bytes apart
      mbar_wait(&v_full[w], i & 1);
      fence_regs(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wg::wgmma_pv<T, WIDE_DC>(oacc, pa[kk], v_addr + kk * 16 * ROW,
                                 P::PIECE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(oacc);
    } else {
      mbar_wait(&v_full[w], i & 1);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&v_empty[w]);      // V's slot is free
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int cw = c0 + w * WIDE_DC;                // this warpgroup's columns
  T* const ob = o + b * o_sb + h * o_sh + cw;
  // O through shared memory the warpgroup alone has read (its Q half, or
  // its ring, which TMA no longer fills): rows of 512 bytes, 16-byte piece
  // c of row r at c ^ (r % 8), so that a warp's 4-byte stores hit 32
  // banks; then each thread stores whole 16-byte pieces, a warp one row's
  // 512 bytes, columns < dh only. Stored from the accumulators' layout, a
  // row's 4-byte pieces 16 KB apart in the model's [B, S, H, D], the two
  // warpgroups' stores took 23% of a warp's time at D = 512
  // (`flash_phases.py --body pair`, PERF.md)
  unsigned char* const os =
      STREAM ? QK + w * SQ * 2 * P::PIECE : Qs + w * P::HALF;
  const int rw = (warp & 3) * 16 + g;             // rows rw, rw + 8 of the tile
#pragma unroll
  for (int j = 0; j < WIDE_DC / 8; ++j) {
    *reinterpret_cast<uint32_t*>(os + rw * 512 + ((j ^ (rw & 7)) << 4) +
                                 4 * t) =
        pack2<T>(oacc[4 * j] * inv0, oacc[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(os + (rw + 8) * 512 +
                                 ((j ^ ((rw + 8) & 7)) << 4) + 4 * t) =
        pack2<T>(oacc[4 * j + 2] * inv1, oacc[4 * j + 3] * inv1);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + w) : "memory");
  const int c = tw & 31, col = 8 * c;            // this thread's piece
  for (int r = tw >> 5; r < BM && q0 + r < S; r += 4) {
    const uint4 x =
        *reinterpret_cast<const uint4*>(os + r * 512 + ((c ^ (r & 7)) << 4));
    T* const dst = ob + (q0 + r) * o_ss + col;
    if (cw + col + 8 <= dh) {
      *reinterpret_cast<uint4*>(dst) = x;
    } else {                            // the head ends in or before it
      const T* e = reinterpret_cast<const T*>(&x);
      for (int i = 0; i < 8 && cw + col + i < dh; ++i) dst[i] = e[i];
    }
  }
}

// The tensor map of a [B, H, S, D] operand (16-bit, or fp8 as UINT8) with
// element strides (sb, sh, ss, 1): dims innermost first, D then the other
// three by ascending stride, so that the map is a packed order whatever the
// caller's layout (the model hands over [B, S, H, D] viewed as [B, H, S,
// D]). Boxes of `cols` columns x `rows` rows of one head of one batch, under
// `swizzle`. `pos` gets the places of S, H and B (2 bits each).
cudaError_t flash_map(CUtensorMap* map, CUtensorMapDataType type,
                      const void* base, int D, int S, int H, int B,
                      long long sb, long long sh, long long ss, int rows,
                      int* pos, int cols = wg::BOX,
                      CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const bool f8 = type == CU_TENSOR_MAP_DATA_TYPE_UINT8;
  struct Dim {
    long long stride;
    int size, box, which;
  } dim[3] = {{ss, S, rows, 0}, {sh, H, 1, 1}, {sb, B, 1, 2}};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (dim[j].stride < dim[i].stride) {
        const Dim tmp = dim[i];
        dim[i] = dim[j];
        dim[j] = tmp;
      }
  cuuint64_t dims[4] = {(cuuint64_t)D, 0, 0, 0}, strides[3];
  cuuint32_t box[4] = {(cuuint32_t)cols, 0, 0, 0};
  *pos = 0;
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)dim[i].size;
    strides[i] = (cuuint64_t)dim[i].stride * (f8 ? 1 : 2);
    box[i + 1] = (cuuint32_t)dim[i].box;
    *pos |= (i + 1) << (2 * dim[i].which);
  }
  return hopper::encode_tensor_map(map, type, 4, base, dims, strides, box,
                                   swizzle);
}

// The three maps of a launch; their innermost extent is dh, so TMA
// zero-fills the columns of a box past the head. 16-bit operands: boxes of
// 64 columns under the 128-byte swizzle. fp8 (`qk_cols` > 0): Q and K in
// boxes of qk_cols columns (one 128- or 64-byte row) under the swizzle of
// that row, V in unswizzled boxes of 64 columns.
cudaError_t flash_maps(CUtensorMapDataType type, const void* q,
                       const void* k, const void* v, int B, int Hq, int Hkv,
                       int S, int dh, const long long* st, int q_rows,
                       int kv_rows, CUtensorMap* tq, CUtensorMap* tk,
                       CUtensorMap* tv, int* pos, int qk_cols = 0) {
  int cols = wg::BOX;
  CUtensorMapSwizzle qk_sw = CU_TENSOR_MAP_SWIZZLE_128B, v_sw = qk_sw;
  if (qk_cols > 0) {
    cols = qk_cols;
    if (qk_cols == 64) qk_sw = CU_TENSOR_MAP_SWIZZLE_64B;
    v_sw = CU_TENSOR_MAP_SWIZZLE_NONE;
  }
  cudaError_t err;
  if ((err = flash_map(tq, type, q, dh, S, Hq, B, st[0], st[1], st[2],
                       q_rows, &pos[0], cols, qk_sw)) != cudaSuccess ||
      (err = flash_map(tk, type, k, dh, S, Hkv, B, st[3], st[4], st[5],
                       kv_rows, &pos[1], cols, qk_sw)) != cudaSuccess)
    return err;
  return flash_map(tv, type, v, dh, S, Hkv, B, st[6], st[7], st[8], kv_rows,
                   &pos[2], wg::BOX, v_sw);
}

// The element loader's operands and the widest load (8, 4, 2 or 1 bytes,
// at least an element) that the head's bytes, every stride and every start
// are multiples of.
wg::ElemSrc elem_src(const void* q, const void* k, const void* v, int dh,
                     int itemsize, const long long* st) {
  wg::ElemSrc a;
  a.q = static_cast<const unsigned char*>(q);
  a.k = static_cast<const unsigned char*>(k);
  a.v = static_cast<const unsigned char*>(v);
  for (int i = 0; i < 9; ++i) a.st[i] = st[i];
  a.width = itemsize;
  for (int w = 8; w > itemsize; w /= 2) {
    bool ok = dh * itemsize % w == 0 &&
              ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % w == 0;
    for (int i = 0; i < 9; ++i) ok = ok && st[i] * itemsize % w == 0;
    if (ok) {
      a.width = w;
      break;
    }
  }
  return a;
}

// Every launch function takes the real head size dh (<= D) and the scale
// 1 / sqrt(dh); D is the body's (Dp of the note at the top).
// F8: fp8 operands (e5m2 when `e5m2`, else e4m3fn; T = __half): by element
// on the f16 code (ELEM), or by TMA with Q K^T on the fp8 wgmma of the kind
// E5 (== e5m2). ELEM: the element loader in place of TMA (no tensor maps).
template <typename T, int D, bool EXACT, bool F8 = false, bool ELEM = false,
          bool E5 = false>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         int B, int Hq, int Hkv, int S, int dh, int causal,
                         int window, float scale, const long long* st,
                         cudaStream_t stream, int e5m2 = 0) {
  using C = wg::Cfg<D, ELEM, F8>;
  constexpr int smem = C::TMA8 ? C::SMEM8 : C::SMEM;
  static hopper::SmemAllowance allowance;
  auto kernel = flash_wgmma_kernel<T, D, EXACT, F8, ELEM, E5>;
  cudaError_t err = hopper::allow_smem(allowance, kernel, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap tq{}, tk{}, tv{};
  wg::ElemSrc src{};
  int pos[3] = {0, 0, 0};
  if constexpr (ELEM) {
    src = elem_src(q, k, v, dh, F8 ? 1 : 2, st);
  } else if ((err = flash_maps(F8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                  : Op16<T>::kMap,
                               q, k, v, B, Hq, Hkv, S, dh, st, C::BM, C::BN,
                               &tq, &tk, &tv, pos,
                               F8 ? C::ROW8 : 0)) != cudaSuccess) {
    return err;
  }
  dim3 grid(Hq, B, (S + C::BM - 1) / C::BM);     // query tiles last
  kernel<<<grid, C::THREADS, smem, stream>>>(
      tq, tk, tv, src, static_cast<T*>(o), S, Hq / Hkv, causal, window,
      scale * 1.4426950408889634f, dh, pos[0], pos[1], pos[2], st[9], st[10],
      st[11], e5m2);
  return cudaGetLastError();
}

// D > 256: a block of two consumer warpgroups for every (head, query
// tile) up to 512, for every (head, query tile, 512-column chunk) above
template <typename T>
cudaError_t launch_wgmma_pair(const void* q, const void* k, const void* v,
                              void* o, int B, int Hq, int Hkv, int S, int dh,
                              int causal, int window, float scale,
                              const long long* st, cudaStream_t stream) {
  using P = wg::Pair;
  const bool stream_qk = dh > 2 * WIDE_DC;
  static hopper::SmemAllowance allow_pair, allow_stream;
  auto kernel = stream_qk ? flash_wgmma_pair_kernel<T, true>
                          : flash_wgmma_pair_kernel<T, false>;
  cudaError_t err = hopper::allow_smem(stream_qk ? allow_stream : allow_pair,
                                       kernel, P::SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  int pos[3];
  if ((err = flash_maps(Op16<T>::kMap, q, k, v, B, Hq, Hkv, S, dh, st,
                        P::BM, P::BN, &tq, &tk, &tv, pos)) != cudaSuccess)
    return err;
  const int chunks = (dh + 2 * WIDE_DC - 1) / (2 * WIDE_DC);
  dim3 grid(Hq * chunks, B, (S + P::BM - 1) / P::BM);
  kernel<<<grid, P::THREADS, P::SMEM, stream>>>(
      tq, tk, tv, static_cast<T*>(o), S, Hq / Hkv, causal, window,
      scale * 1.4426950408889634f, dh, chunks, pos[0], pos[1], pos[2],
      st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <typename T, int D, bool EXACT>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hkv, int S, int dh, int causal,
                       int window, float scale, const long long* st,
                       cudaStream_t stream) {
  static hopper::SmemAllowance allowance;
  auto kernel = flash_mma_kernel<T, D, EXACT>;
  const size_t smem = MmaCfg<D>::SMEM;
  cudaError_t err = hopper::allow_smem(allowance, kernel, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BM - 1) / BM, Hq, B);
  kernel<<<grid, MMA_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Hq / Hkv, causal,
      window, scale * 1.4426950408889634f, dh, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

// The bytes of the fma body's loads of q, k, v: 16 (cp.async) for float32
// rows of dh columns whose strides (st, elements) and starts are multiples
// of 4 floats; else the widest of 8, 4, 2 and 1 bytes, and of one element
// at least, that the row's bytes, every stride and every start are
// multiples of (16-bit rows at D 500: 8).
int fma_load(int esize, const void* q, const void* k, const void* v,
             int dh, const long long* st) {
  const uintptr_t starts = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  for (int bytes = 16; bytes > esize; bytes /= 2) {
    if (bytes == 16 && esize != 4) continue;
    bool ok = (long long)dh * esize % bytes == 0 && starts % bytes == 0;
    for (int i = 0; i < 9; ++i) ok = ok && st[i] * esize % bytes == 0;
    if (ok) return bytes;
  }
  return esize;
}

// The card's SMs (of the current device), read once a device.
int card_sms() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && sms[dev] > 0) return sms[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) sms[dev] = n;
  return n;
}

// A block of the fma body at Dp = D of ROWS query rows for every (batch,
// head, query tile); the query tile the slowest grid dimension
template <int D, bool EXACT, typename E, int ROWS>
cudaError_t launch_fma_rows(const void* q, const void* k, const void* v,
                            void* o, int B, int Hq, int Hkv, int S, int dh,
                            int causal, int window, float scale,
                            const long long* st, cudaStream_t stream) {
  static hopper::SmemAllowance allowance;
  auto kernel = flash_fma_kernel<E, D, EXACT, ROWS, false>;
  const size_t smem = FmaRing<D, ROWS>::SMEM;
  cudaError_t err = hopper::allow_smem(allowance, kernel, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hq * B, (S + ROWS - 1) / ROWS);
  const int load = fma_load(sizeof(E), q, k, v, dh, st);
  kernel<<<grid, FMA_NT + FMA_PT, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<E*>(o), S, Hq, Hq / Hkv, causal,
      window, scale * 1.4426950408889634f, dh, load, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

// The fma body up to 256 columns, its query rows a block by `fma_rows`
template <int D, bool EXACT, typename E>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hkv, int S, int dh, int causal,
                       int window, float scale, const long long* st,
                       cudaStream_t stream) {
  if constexpr (D == 64 || D == 128) {
    if (fma_rows(D, B, Hq, S, card_sms()) == 64)
      return launch_fma_rows<D, EXACT, E, 64>(q, k, v, o, B, Hq, Hkv, S, dh,
                                              causal, window, scale, st,
                                              stream);
  }
  return launch_fma_rows<D, EXACT, E, FmaRing<D>::BMF>(
      q, k, v, o, B, Hq, Hkv, S, dh, causal, window, scale, st, stream);
}

// CTAs a cluster of the fma body above 256 columns: one a 256-column piece
// of the head, at most FMA_CLUSTER (the pieces past FMA_CLUSTER in further
// clusters, a grid dimension); 1 up to 256.
int fma_cluster(int D) {
  const int npc = (D + WIDE_DC - 1) / WIDE_DC;
  return D <= WIDE_DC ? 1 : npc < FMA_CLUSTER ? npc : FMA_CLUSTER;
}

// The launch configuration of the fma body above 256 columns: a cluster of
// fma_cluster(dh) CTAs for every (batch, head, query tile, chunk of
// FMA_CLUSTER pieces), the query tile the slowest grid dimension, in
// `attr` the cluster's dimensions.
cudaLaunchConfig_t fma_wide_config(int B, int Hq, int S, int dh,
                                   cudaStream_t stream,
                                   cudaLaunchAttribute* attr) {
  using C = FmaRing<WIDE_DC, 64, true>;
  const int n = fma_cluster(dh);
  const int chunks = ((dh + WIDE_DC - 1) / WIDE_DC + n - 1) / n;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * chunks * Hq * B, (S + C::BMF - 1) / C::BMF);
  cfg.blockDim = dim3(FMA_NT + FMA_PT);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename E>
cudaError_t launch_fma_wide(const void* q, const void* k, const void* v,
                            void* o, int B, int Hq, int Hkv, int S, int dh,
                            int causal, int window, float scale,
                            const long long* st, cudaStream_t stream) {
  static hopper::SmemAllowance allowance;
  auto kernel = flash_fma_kernel<E, WIDE_DC, false, 64, true>;
  cudaError_t err = hopper::allow_smem(
      allowance, kernel, (int)FmaRing<WIDE_DC, 64, true>::SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      fma_wide_config(B, Hq, S, dh, stream, &attr);
  const int load = fma_load(sizeof(E), q, k, v, dh, st);
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<E*>(o), S, Hq, Hq / Hkv, causal,
      window, scale * 1.4426950408889634f, dh, load, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

enum Body {
  BODY_NONE = -1, BODY_FMA = 0, BODY_WGMMA = 1, BODY_MMA = 2,
  BODY_WGMMA_ELEM = 3
};

// Dp of the note at the top: the body's head size for a launch at D (above
// 256, the WIDE_DC-column chunks that cover it); 0 for D < 1.
int padded(int D) {
  if (D > WIDE_DC) return (D + WIDE_DC - 1) / WIDE_DC * WIDE_DC;
  for (int p = 16; p <= WIDE_DC; p *= 2)
    if (D >= 1 && D <= p) return p;
  return 0;
}

// The fixed rule of the note at the top: float32 -> fma at every head size;
// bfloat16 and float16 rows of whole 16-byte pieces (D % 8 == 0) -> wgmma
// at Dp >= 64 and mma.sync at Dp <= 32, other rows -> wgmma with the
// element loader at Dp 64 to 256, else fma; fp8 -> wgmma (TMA tiles
// converted to f16) where D % 16 == 0 and Dp is 64 to 256, the element
// loader at other D of those Dp, else fma.
Body body_for(int dtype, int D) {
  const int Dp = padded(D);
  if (Dp == 0) return BODY_NONE;
  const bool tc = Dp >= 64 && Dp <= WIDE_DC;      // Dp of flash_wgmma_kernel
  if (dtype == DTYPE_E4M3 || dtype == DTYPE_E5M2)
    return !tc ? BODY_FMA : D % 16 == 0 ? BODY_WGMMA : BODY_WGMMA_ELEM;
  if (dtype == DTYPE_F32) return BODY_FMA;
  if (dtype == DTYPE_BF16 || dtype == DTYPE_F16) {
    if (D % 8 == 0) return Dp >= 64 ? BODY_WGMMA : BODY_MMA;
    return tc ? BODY_WGMMA_ELEM : BODY_FMA;
  }
  return BODY_NONE;
}

// The launch of `body` at Dp for operands of type E.
template <typename E>
int launch_typed(Body body, int Dp, const void* q, const void* k,
                 const void* v, void* o, int B, int Hq, int Hkv, int S, int D,
                 int causal, int window, float scale, const long long* st,
                 cudaStream_t s) {
#define FLASH_ARGS q, k, v, o, B, Hq, Hkv, S, D, causal, window, scale, st, s
#define FLASH_CASE(LAUNCH, DIM)                                          \
  case DIM:                                                              \
    return static_cast<int>(Dp == D ? LAUNCH<E, DIM, true>(FLASH_ARGS)   \
                                    : LAUNCH<E, DIM, false>(FLASH_ARGS))
#define FMA_CASE(DIM)                                                    \
  case DIM:                                                              \
    return static_cast<int>(Dp == D ? launch_fma<DIM, true, E>(FLASH_ARGS) \
                                    : launch_fma<DIM, false, E>(FLASH_ARGS))
#define FMA_PADDED(DIM) \
  case DIM:             \
    return static_cast<int>(launch_fma<DIM, false, E>(FLASH_ARGS))
#define ELEM_CASE(DIM) \
  case DIM:            \
    return static_cast<int>(launch_wgmma<E, DIM, false, false, true>(FLASH_ARGS))
  constexpr bool kF32 = std::is_same_v<E, float>;
  if (body == BODY_FMA) {
    if (Dp > WIDE_DC) return static_cast<int>(launch_fma_wide<E>(FLASH_ARGS));
    if constexpr (kF32) {
      switch (Dp) {
        FMA_CASE(16);
        FMA_CASE(32);
        FMA_CASE(64);
        FMA_CASE(128);
        FMA_CASE(256);
      }
    } else {        // fp8 and 16-bit rows below 64 columns: by element
      switch (Dp) {
        FMA_PADDED(16);
        FMA_PADDED(32);
      }
    }
  }
  if constexpr (!kF32 && !is_fp8<E>) {
    if (body == BODY_WGMMA) {
      if (Dp > WIDE_DC)
        return static_cast<int>(launch_wgmma_pair<E>(FLASH_ARGS));
      switch (Dp) {
        FLASH_CASE(launch_wgmma, 64);
        FLASH_CASE(launch_wgmma, 128);
        FLASH_CASE(launch_wgmma, 256);
      }
    }
    if (body == BODY_WGMMA_ELEM) {
      switch (Dp) {
        ELEM_CASE(64);
        ELEM_CASE(128);
        ELEM_CASE(256);
      }
    }
    if (body == BODY_MMA) {
      switch (Dp) {
        FLASH_CASE(launch_mma, 16);
        FLASH_CASE(launch_mma, 32);
      }
    }
  }
  return -1;
#undef ELEM_CASE
#undef FMA_PADDED
#undef FMA_CASE
#undef FLASH_CASE
#undef FLASH_ARGS
}

}  // namespace

// The body `flash_attention_launch` runs for (dtype, D): 0 fma, 1 wgmma,
// 2 mma.sync, 3 wgmma with the element loader, -1 none (the wrapper's
// `body_for` states the same rule).
extern "C" int flash_attention_body(int dtype, int D) {
  return static_cast<int>(body_for(dtype, D));
}

// Blocks a (head, query tile) of a launch at (dtype, D): 1 up to 256; in
// the wgmma body above, one a 512-column chunk of the output (the pair
// body: ceil(D / 512)); in the fma body above 256, the CTAs of its clusters
// (`flash_attention_cluster`), one a 256-column piece of the output and
// FMA_CLUSTER a chunk of FMA_CLUSTER pieces above 2048 (n ceil(Dp / (256
// n)), each cluster's CTAs summing all of Q K^T between them); 0 for a
// head size or type no body takes (the wrapper's `wide_blocks` states the
// same rule).
extern "C" int flash_attention_wide_blocks(int dtype, int D) {
  const Body body = body_for(dtype, D);
  const int Dp = padded(D);
  if (body == BODY_NONE) return 0;
  if (Dp <= WIDE_DC) return 1;
  if (body == BODY_WGMMA) return (D + 2 * WIDE_DC - 1) / (2 * WIDE_DC);
  const int n = fma_cluster(D);
  return n * ((Dp / WIDE_DC + n - 1) / n);
}

// CTAs a cluster of a launch at (dtype, D): in the fma body above 256
// columns one a 256-column piece of the head, at most FMA_CLUSTER; 1 for
// every other launch; 0 for a head size or type no body takes (the
// wrapper's `fma_cluster`).
extern "C" int flash_attention_cluster(int dtype, int D) {
  const Body body = body_for(dtype, D);
  if (body == BODY_NONE) return 0;
  return body == BODY_FMA ? fma_cluster(D) : 1;
}

// Query rows a block of the fma body at (dtype, D) for B x Hq heads of S
// rows on a card of `sms` SMs (`fma_rows`); 0 where another body runs (the
// wrapper's `fma_rows`).
extern "C" int flash_attention_fma_rows(int dtype, int D, int B, int Hq,
                                        int S, int sms) {
  if (body_for(dtype, D) != BODY_FMA) return 0;
  return fma_rows(padded(D), B, Hq, S, sms);
}

// The clusters of n CTAs of the fma body above 256 columns (its float32
// instantiation) that the current card can hold at once
// (cudaOccupancyMaxActiveClusters), or minus a cudaError_t.
extern "C" int flash_attention_fma_clusters(int n) {
  static hopper::SmemAllowance allowance;
  auto kernel = flash_fma_kernel<float, WIDE_DC, false, 64, true>;
  cudaError_t err = hopper::allow_smem(
      allowance, kernel, (int)FmaRing<WIDE_DC, 64, true>::SMEM);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  // a head of n pieces, so clusters of n CTAs
  cudaLaunchConfig_t cfg =
      fma_wide_config(1, 1024, 64, n * WIDE_DC, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : clusters;
}

// q, o [B, Hq, S, D]; k, v [B, Hkv, S, D], D >= 1, all of one type (float32,
// bfloat16, float16, float8_e4m3fn or float8_e5m2: the wrapper widens mixed
// types and integers to float32); last
// stride 1, the others given in elements as strides = {q_sb, q_sh, q_ss,
// k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss}: for the TMA-fed
// wgmma and the mma bodies multiples of 16 bytes with starts 16-byte
// aligned, for the fma body and the element loader anything (fp32 at D of
// 16, 32, 64, 128 or 256: multiples of 4, starts 16-byte aligned). The
// scale is 1 / sqrt(D). Returns 0 or a cudaError_t; -1 for a head size or
// type it does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int S, int D, int causal,
                                      int window, const long long* strides,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Dp = padded(D);
  const float scale = static_cast<float>(1.0 / sqrt((double)D));
  const Body body = body_for(dtype, D);
  if (body == BODY_NONE) return -1;
  if (dtype == DTYPE_F32)
    return launch_typed<float>(body, Dp, q, k, v, o, B, Hq, Hkv, S, D, causal,
                               window, scale, strides, s);
  if (dtype == DTYPE_BF16)
    return launch_typed<__nv_bfloat16>(body, Dp, q, k, v, o, B, Hq, Hkv, S,
                                       D, causal, window, scale, strides, s);
  if ((dtype == DTYPE_E4M3 || dtype == DTYPE_E5M2) && body != BODY_FMA) {
    // the element loader takes both kinds in one instantiation, the kind a
    // launch argument; the TMA body has one a kind (its wgmma's type)
    const int e5m2 = dtype == DTYPE_E5M2;
#define FP8_ARGS                                                         \
  q, k, v, o, B, Hq, Hkv, S, D, causal, window, scale, strides, s, e5m2
#define FP8_TMA(DIM, E5)                                                 \
  (Dp == D ? launch_wgmma<__half, DIM, true, true, false, E5>(FP8_ARGS)  \
           : launch_wgmma<__half, DIM, false, true, false, E5>(FP8_ARGS))
#define FP8_CASE(DIM)                                                    \
  case DIM:                                                              \
    return static_cast<int>(                                             \
        body == BODY_WGMMA_ELEM                                          \
            ? launch_wgmma<__half, DIM, false, true, true>(FP8_ARGS)     \
        : e5m2 ? FP8_TMA(DIM, true)                                      \
               : FP8_TMA(DIM, false))
    switch (Dp) {
      FP8_CASE(64);
      FP8_CASE(128);
      FP8_CASE(256);
    }
#undef FP8_CASE
#undef FP8_TMA
#undef FP8_ARGS
    return -1;
  }
  if (dtype == DTYPE_E4M3)
    return launch_typed<fp8_e4m3>(body, Dp, q, k, v, o, B, Hq, Hkv, S, D,
                                  causal, window, scale, strides, s);
  if (dtype == DTYPE_E5M2)
    return launch_typed<fp8_e5m2>(body, Dp, q, k, v, o, B, Hq, Hkv, S, D,
                                  causal, window, scale, strides, s);
  return launch_typed<__half>(body, Dp, q, k, v, o, B, Hq, Hkv, S, D, causal,
                              window, scale, strides, s);
}
