// paged_attention: single-token decode attention over a contiguous KV cache
// with a valid prefix per sequence, in one launch.
//
// Replaces the TPU kernel `_paged_kernel` / `paged_attention` of
// src/repro/kernels/paged_attention.py. There the page axis is a sequential
// grid axis: each step's page of K and V arrives in VMEM by a DMA the
// pipeline issues ahead, and (m, l, acc) are carried in scratch from one page
// to the next; pages past lengths[b] are skipped.
//
// Bound on this card: bytes. Every valid K and V row is read once and used
// for one dot product and one update a query head of its GQA group (G = 8 at
// qwen2.5-3b's width), far below the operations a byte the card needs to be
// compute bound. At the serve shape (B = 4, two KV heads, 2614 valid rows a
// head) the valid K/V is 2.68 MB, ~20 KB an SM, while 3.35 TB/s x ~0.7 us
// of DRAM latency needs ~2.3 MB in flight across the card: by Little's law
// a block has to put its whole share of rows in flight before it waits on
// the first. The design is the paper's mechanism:
//
//   - aload = one mbarrier phase of a shared-memory slot: a producer warp
//     (the 17th) arms the slot with expect_tx(bytes) and issues TMA tile
//     loads (cp.async.bulk.tensor) of `rows` = min(page, 32) rows of one
//     (b, KV head) of K and of V, through tensor maps over the caches' own
//     [B, T, Hkv, D] strides, in boxes of at most 128 bytes of a row (two a
//     tensor at bf16 D = 128); getfin = try_wait.parity on the slot's *full*
//     mbarrier. A ring of up to 8 slots (`ring_slots`: one block an SM) is
//     primed with every chunk of the block's share before the first wait,
//     and the producer refills a slot once the 8 consumer warps of the set
//     that took it have arrived on its *empty* mbarrier. Rows past T arrive
//     as zeros; rows past the chunk are masked;
//   - the work is split from `lengths` on the device, never by the host
//     (which would cost a synchronisation a layer a step): every block scans
//     the lengths into prefix sums in shared memory, lays the valid rows of
//     all segments end to end, W rows in all, and takes rows [i * ceil(W /
//     blocks), (i + 1) * ceil(W / blocks)). A segment is (b, KV head, group
//     of up to 8 query heads; of 16 on the tensor cores above 8: see "Two
//     query heads a warp" below), or, below 8 query heads a KV head, (b, run
//     of KV heads): see "Segments of several KV heads" below. So the blocks
//     share the valid rows evenly, a block may span segments and a segment
//     blocks, and no block walks a masked row. The host plans only the grid
//     from T, B, Hkv and the card (`locate`, `block_chunks` and `pieces` in
//     paged_attention.py mirror the split for the CPU tests);
//   - one launch: a block that ends its share of a segment that other
//     blocks share writes a partial (m, l, acc) to the workspace and takes a
//     ticket by one atom.add.acq_rel.gpu after a barrier (release: the
//     block's partial is visible first; acquire: the last block sees every
//     other's); the last block of the segment merges the partials, its two
//     warp sets half each, 4 partials' loads in flight a warp (with 8 or 16
//     the 96 registers a thread of a 17-warp block spill), writes `out`
//     and resets the ticket to 0 for the next call. A segment a block
//     holds alone is written directly. A segment with no valid row
//     (lengths[b] <= 0) gets 0, as in the reference kernel;
//   - two sets of 8 consumer warps take the chunks in turn (even, odd), each
//     with its own (m, l, acc), handed over through shared memory at the
//     end of a segment; warp w of a set owns query head w of a group of up
//     to 8 (and w + 8 of a group of 16: G > 8 on the tensor cores; G < 8,
//     several KV heads) for the softmax, a lane a row of the chunk, so a
//     chunk's max and sum take 10 shuffles a head;
//   - bf16 and f16 at D = 64 to 256 and 512 (`tensor_core_qk`; 512: "Above
//     256 columns" below): Q K^T by mma.sync
//     m16n8k16, K rows as A (ldmatrix from the 128-byte swizzled boxes, so 8
//     rows are read without bank conflicts), the group's 8 queries as B in
//     registers; bf16 products are exact in fp32. P V by mma.sync too, warp
//     w taking columns [w D / 8, (w + 1) D / 8) of all heads: P is split
//     into two bf16 parts, p = hi + lo, and both go through the tensor
//     cores, so P keeps ~16 bits and the result fp32's accuracy (the bf16
//     checks need no P term, unlike flash's); V by ldmatrix.trans. f16 runs
//     the same code with E = __half (the mma type field, P's two parts in
//     f16, the TMA map's type). fp32, 16-bit at D = 16 and 32, a 16-bit
//     cache under a q of another float type (EQ = q_as<float>: q read and
//     the output written in q's own type, the caches in theirs, never
//     copied) and the wide body stay on fp32 FMAs: Q K^T
//     with a lane on D/32
//     columns and one transpose reduction (31 shuffles a chunk) that leaves
//     row r's logit on lane r, P V with p_r broadcast by a shuffle.
//     expf, as the reference; the output is cast to the input type.
//
// fp8 caches (e4m3fn, e5m2): read as fp8 from device memory, D bytes a row,
// by the TMA ring where D % 16 == 0 (the maps' type UINT8) and by the
// element body elsewhere, never widened into a copy (a decode step's bytes
// are the caches'). Both kinds are one load type (`fp8_any`, the kind a
// launch argument). q is read in its own type (f32, bf16, f16, e4m3fn,
// e5m2: `q_as`, the type a launch argument, `Args::qt`), one load at a
// segment's start, and the output written in it (fp8 by `to_fp8`, no
// saturation), so that a call is one kernel and the wrapper runs no torch
// op around it. The products (`products`, the wrapper's `products_on`):
//   - on the tensor cores, for a q of 16 bits or fp8 at Dp 64 to 256 on the
//     TMA ring: every e4m3fn and e5m2 value is exact in f16 and in bf16, so
//     K and V are converted in registers after ldmatrix (e5m2 by a byte
//     permute, e4m3fn by cvt.rn.f16x2.e4m3x2; bf16 through fp32) and run on
//     mma_16816 as the 16-bit body does: f16 products where q is f16 or fp8,
//     bf16 where q is bf16, P in two parts of that type. K is the A operand
//     read by ldmatrix of the fp8 rows viewed as b16: a lane gets 4
//     consecutive columns of a row, so an mma's k order is (4t, 4t + 1,
//     4t + 2, 4t + 3) where the 16-bit body's is (2t, 2t + 1, 2t + 8, 2t + 9),
//     and q's fragments follow it. V needs two keys of one column in a
//     register, which ldmatrix.trans gives only for 16-bit elements: read as
//     b16 it gives a lane rows 2t and 2t + 1 of two neighbouring columns, and
//     a byte permute makes of them one pair for the even column and one for
//     the odd one, two n-tiles; `finish` puts the columns back in order.
//     The boxes' rows are 128 bytes (64 at D = 64, under the 64-byte
//     swizzle), so at D = 64 four warps take P V, 16 columns each. So
//     both products take the mma count of the 16-bit body on half its
//     bytes;
//   - on fp32 FMAs otherwise (an fp32 q, Dp 16 and 32, the element body,
//     the wide body), each value widened where the FMAs read it
//     (`load_row`), exact.
// Integer caches take fp32 copies (the reference's `.astype(float32)`).

// Head sizes: every D from 1 up, as the TPU kernel takes. Let Dp be the
// smallest of 16, 32, 64, 128 and 256 that is at least D (above 256, D
// rounded up to 256: the wide body below). At D == Dp (EXACT)
// the body above runs as described, D = 256 with 4 TMA boxes a row (bf16; 8
// in fp32), a warp's P V columns in two ldmatrix.x4 loads and a ring of as
// many slots as fit (`ring_slots`). At any other D the body for Dp runs with
// the real D a runtime argument:
//   (a) the loads: where a row of D elements is a whole number of 16-byte
//       pieces (bf16 D % 8 == 0, fp32 D % 4 == 0), TMA as above, the tensor
//       maps' innermost extent D, so that TMA zero-fills columns D .. Dp-1
//       (and bf16 at Dp >= 64 keeps the tensor cores); elsewhere one head's
//       row cannot be a TMA box, and the slots are the unpadded layout of
//       the segment body below, [rows][heads][dh] (HEADS; "Rows of no whole
//       16-byte pieces" below), both products on FMAs. Q loads by element,
//       its tail as zeros;
//   (b) the stores write columns < D only (`out` rows may be wider);
//   (c) the scale is 1 / sqrt(D), computed by the launch, not of Dp.
// The partials' workspace and the exchange buffers are sized for Dp. The
// rule, also in `paged_attention_body` and the wrapper's `body_for`: "tma"
// where D * item % 16 == 0, else "element".
//
// Rows of no whole 16-byte pieces (D * item % 16 != 0, Dp up to 256): the
// element body copied each chunk by element, 1-2 bytes a load and 8 loads
// in flight a lane of one producer warp, over the zero columns D .. Dp-1
// too, so its consumers waited on the copy 59-80% of their time
// (`paged_phases.py`, PERF.md: fp8 D = 100, bf16 D = 100 at 16 KV heads),
// and it took segments of one KV head. Now these rows take the unpadded
// slots of the segment body (HEADS), segments of several KV heads below 8
// query heads a KV head as there (`kv_run`), and one of two loaders,
// decided at launch from the caches' strides (`run_box`, the wrapper's
// `run_heads` and `route`):
//   - a run of heads by TMA: the caches are [B, T, Hkv, D], so where a
//     token's heads are contiguous (sh == D), a run of R of them is whole
//     16-byte pieces although one head's row is not, and the other strides
//     and the starts are multiples of 16 bytes, one TMA box over the [B, T,
//     Hkv * D] view brings `rows` rows of the run: R the smallest multiple
//     of the segment's KV heads that divides Hkv (fp8 D = 8 at Hkv 2: both
//     heads of a token, 16 bytes, for segments of one; bf16 D = 100 at Hkv
//     16: the segment's 8), the box cut into `box_n` runs of `box_w` <= 256
//     elements (`box_width`). A warp reads its KV head's rows at its place
//     in the run (`kv_row`);
//   - elsewhere (strided heads, a run that no multiple makes whole pieces,
//     an unaligned start) the producer warp copies the rows into the same
//     layout, in loads as wide as the head's bytes, the strides and the
//     starts allow (16, 8, 4, 2 or 1 bytes: `copy_width`), by cp.async
//     whose completion makes the lane's arrival where they are 4 bytes or
//     wider, else byte by byte (`copy_units`); no zero column is written
//     or read: the consumers
//     read a lane's columns as one vector where the row's are whole
//     vectors of it, else one element a load, 0 past dh (`load_cols`).
//
// Above 256 columns, 16-bit caches under a q of their type with rows of
// whole 16-byte pieces up to D = 512 (Dp = MMA_WIDE; `products`) take the
// tensor-core body above at Dp 512, a block's
// segment the whole head, so K is read once and the grid has one
// dimension. A slot holds `rows` rows of K and of V, 8 swizzled 128-byte
// TMA boxes a row each (64 KB at 32 rows: 2 slots fit beside the rest).
// Q K^T by mma.sync over D / 16 k-steps, K rows as the A operand by
// ldmatrix from the boxes; q staged once a segment in the set's tacc, [8][D
// + QPAD] 16-bit, and read a k-step at a time by ldmatrix.x2, as the
// two-heads-a-warp body reads its 16 (held as B fragments q would take 64
// registers a lane); the even and the odd k-steps in two chains of mma,
// added at the end. P V by mma.sync, warp w on D / 8 = 64 columns of all
// heads (32 fp32 accumulators), P in its two 16-bit parts; the partials
// and the merge at D columns (16-byte loads, 2 partials a batch). Rules
// (a)-(c) hold as below: TMA zero-fills columns past D (boxes wholly past
// it too), stores write columns < D only, the scale is 1 / sqrt(D). The
// segment's blocks merge in two levels (MERGE_GROUP, as at HX 2): a
// partial is D columns a head. P V loads a warp's V 16 columns at a time
// beside their mma, so that the 544-thread block's 96 registers a thread
// hold it (loading all 64 first spilled 588 bytes). Before it this head
// size took the wide body below: 0.0361-0.0368 ms at qwen2.5-3b's decode
// layout B4 Hq16 Hkv2 T1032, D = 512 bf16, against ~0.033 now; with the
// products off the critical path (a set's Q K^T and P V ~4k cycles), a
// block's start before its first chunk and the last block's merge set the
// pace (`paged_phases.py`, PERF.md). fp32 and fp8 caches, a q of another
// type, rows of no whole pieces and every type above 512 take the wide
// body on FMAs.
//
// The wide body (`paged_wide_kernel`): a block's segment is the whole head
// up to 2048 columns, so each K and V row enters the ring once and each
// row's logits are computed once. (Above 2048 the output is cut into
// chunks of 2048 columns, a grid dimension, `wide_chunks`, each with its
// own blocks, partials and tickets: each chunk's blocks take all of K's
// pieces, the logits being over the whole head, and the chunk's of V; so
// K is read once a chunk.) Before it, the output was cut into Dp / 256
// chunks of 256 columns, each its own blocks over every valid row (sms /
// chunks of them), its own partials and tickets, and a slot row held all
// of K's columns: K was read Dp / 256 times, Q K^T computed as often, a
// chunk's blocks were an eighth of the card at D = 2048 and a slot of fp32
// rows at D = 2048 held 7 (0.2626 ms at qwen2.5-3b's decode layout at
// D = 2048 bf16, 0.0773 at 1024; `paged_phases.py` showed the FMAs of Q
// K^T, the softmax and P V taking 68-83% of a set's time). Now:
//   - pieces through the ring: an aload is one piece of WIDE_DC columns of
//     K or of V of `rows` rows (TMA boxes of 128 bytes a row, unswizzled;
//     rows of no whole 16-byte pieces copied by element by the producer
//     warp, columns past dh zero), a chunk of rows all of K's pieces, then
//     the column chunk's V pieces, through a ring of as many slots as fit beside the
//     accumulators (`wide_ring_slots`: 8 of 16 KB in bf16, 8 of 8 KB in
//     fp8; in fp32 of 32 KB, 6 at D <= 512, 5 up to 1536, 4 above). getfin
//     is the wait on a slot's full barrier; the 8 warps that read a piece
//     free its slot;
//   - both consumer sets take every chunk: warp (w, s) of set s takes query
//     head w and the pieces of parity s, so each piece is read by 8 warps
//     (once a head) and each warp holds the output columns of its pieces:
//     at 2048 columns 4 pieces, 32 fp32 accumulators a lane;
//   - Q K^T: a warp takes a lane's 8 columns of each of its K pieces as it
//     lands, q's piece loaded by element, over every row of the chunk, and
//     a transpose reduction a piece leaves the piece's part of row r on
//     lane r (summing over the pieces before one reduction kept 32 sums
//     live across the waits and spilled); the two parities' parts are
//     added through shared memory (one barrier of the consumers a chunk,
//     two buffers), and both warps of a head run the same softmax on the
//     same sums (expf, as the reference);
//   - P V: each warp rescales its accumulators by alpha and adds p_r V[r]
//     over its V pieces, p_r broadcast by a shuffle. The accumulators of
//     a warp's pieces live in shared memory (16 KB a piece a warp takes:
//     64 KB at 2048 columns; sized to the head, so that a narrower head's
//     ring is deeper: at fp32 D = 512 one piece, 6 slots where 64 KB left
//     4, which held one chunk of rows), in registers only
//     while P V runs over their piece: the 544-thread block has 96
//     registers a thread, and holding them beside Q K^T's 32 partial sums
//     spilled 650-1124 bytes (ptxas), at 0.1402 ms at D = 2048 bf16;
//   - partials of D columns a head (of the chunk's), merged in the two
//     levels of MERGE_GROUP, each warp its head's columns of its pieces;
//   - rules (a)-(c): TMA zero-fills columns past D (boxes wholly past it
//     too), stores write columns < D only, the scale is 1 / sqrt(D).
//
// Segments of several KV heads (HEADS, `kv_run`): at G < 8 query heads a KV
// head (G dividing 8), a segment of one KV head leaves 8 - G of a set's 8
// warps idle in every chunk's softmax and 8 - G of the 8 columns of the mma's
// B fragment zero, and its chunks carry G heads' work each, so a block's
// share at G = 1 is 8x the chunks of G = 8 at the same rows: timestamps per
// block (`paged_phases.py`, PERF.md) showed a set's chunks, and the query
// loads of each new segment queued behind the ring's whole share of the
// caches, taking most of its time at Hkv = 16, D = 80. So 16-bit caches under
// a q of their type on the TMA ring at Dp 64 to 256 take segments of R = 8 /
// G KV heads of one sequence (halved until R divides Hkv) at G = 1, and at G
// = 2 and 4 where D < Dp (where D == Dp, the tensor cores with G real B
// columns measured faster; PERF.md): the caches are [B, T, Hkv, D], so one
// TMA box of `rows` rows x R heads x dh columns brings all their K (and one
// their V), laid out [rows][R][dh] unpadded (columns past dh are neither
// loaded nor read); warp w of a set takes query head w of the segment and
// reads the rows of KV head w / G; Q K^T runs on FMAs, a lane on D / 32
// columns of every row (no mma B column would be zero, nor real but for one
// head), then the one transpose reduction, the softmax and P V as above, each
// warp on its own head. The split, the partials and the merge are the G = 8
// design's, with R * G = 8 query heads a segment. An aload holds at most
// HEADS_SLOT_BYTES (paged_attention.py) of K and V: halving it to 32 KB
// measured slower at every head size (PERF.md), and making the consumers'
// first query loads go before the ring's (a barrier the producer waited on)
// slower still.
//
// Two query heads a warp (HX 2, `group_heads`): above 8 query heads a KV
// head (recurrentgemma-9b: 16 over one) a segment of 8 query heads walked
// every valid row of its KV head once for each group, so each K and V row
// went through the ring twice, the split spread twice the rows over the
// blocks, and twice the partials were merged. So where the products run on
// the tensor cores (`products`: 16-bit caches under their own q, fp8 caches
// under a 16-bit or fp8 q, TMA rows) at Dp 256 a segment serves 16 query
// heads of one KV head (G = 12: 12 of them, the last four masked; G = 32:
// two groups of 16): each row enters the ring once for all of them. (At Dp
// 64 and 128 the same body measured 3-10% slower than two groups of 8 at
// B4 Hq16 Hkv1 T4128, its partials' merge costing more than the rows it
// saves, so those keep segments of 8; PERF.md.)
// The mma shapes take the second 8 heads at little cost: Q K^T puts the 16
// queries in two n8 tiles against the same K A fragments (a warp of rows 0
// to 15 or 16 to 31 issues two mma.sync a k-step where one took one), and P
// V, whose A rows 8 to 15 were zeros at 8 heads, now holds P of heads 8 to
// 15 there (the same mma count). q is staged once a segment in the set's
// `tacc`, [16][D + QPAD] 16-bit, and read a k-step at a time by one
// ldmatrix.x4 that gives both tiles' B fragments (fp8 caches: each 16
// columns stored in the A fragments' k order), where the 8-head body holds
// its D / 8 fragment registers for the segment; at D = 256 the 16 heads'
// would be 64 registers. Warp w of a set takes the softmax of heads w and w
// + 8 and their (m, l, acc); a partial holds HS = 16 heads. One segment a
// KV head spreads over twice the blocks of a group of 8 (recurrentgemma's
// 4128 rows: 53 of 132), and a partial is twice the bytes, so the last
// block's merge read 4x what it read at 8 heads: per-block timestamps
// (`paged_phases.py`, PERF.md) showed it taking most of the launch. So the
// blocks of a segment merge in two levels: the last of each group of
// MERGE_GROUP (8) consecutive blocks merges the group's partials into the
// group's first (a ticket a group), and the last of those mergers merges
// the groups' into out (the segment's ticket); in both, set s takes heads
// 8 s to 8 s + 7 over all the pieces (no hand-over between the sets), and
// the partials at D = 256 are read by 16-byte loads (`ldcg_vec`). The
// segment's first q loads issued before the ring's (a barrier the producer
// waited on) measured slower, as they did for segments of several KV heads.
//
// What the design steps measured (H100, `kernel_bench.py` and timestamps
// per block; PERF.md): one cp.async.bulk a row issued by the consumers cost
// ~5 us a chunk; with TMA boxes and a producer warp the arithmetic on FMAs
// was ~2 us a chunk, latency-bound; on the tensor cores it is ~0.8 us, and
// the last block's merge is the longest single step.

#include <type_traits>

#include "amu_ring.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;
using namespace repro::hopper;

constexpr int GC = 8;            // query heads a block serves, a warp each
constexpr int MAX_SLOTS = 8;     // slots a ring: 256 rows in flight a block
constexpr int NSET = 2;          // sets of GC warps, taking chunks in turn
constexpr int MERGE_GROUP = 8;   // blocks a first-level merge (HX 2)
constexpr int NT = NSET * GC * 32;   // consumer threads; one producer warp
constexpr int PSTR = 40;         // bf16 row stride of P: conflict-free reads
// floats of one exchange buffer of a set serving HS query heads: logits, P
// hi and lo, alpha
__host__ __device__ constexpr int xch_floats(int HS) {
  return HS * 32 + HS * PSTR + HS;
}
// q's row stride, in 16-bit elements, where a set stages it for ldmatrix
// (HX 2): D + 8, so that the 8 rows an ldmatrix reads sit 16 bytes apart
// modulo 128 and no two share a bank
constexpr int QPAD = 8;
constexpr unsigned FULL = 0xffffffffu;
// the most bytes of K and V an aload of unpadded slots holds (the plan's
// rows: HEADS_SLOT_BYTES of paged_attention.py)
constexpr int HEADS_SLOT_BYTES = 65536;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;
  float* part;                   // [pieces][HS m, HS l, HS x D acc]
  int* tickets;                  // [segments x (1 + groups)], zero between
                                 // launches (groups: `ngroups`)
  int B, Hq, Hkv, T, G, ngc, rows, slots;
  int dh;                        // the real head size, <= D (see the note)
  int npk;                       // the wide body's pieces of WIDE_DC
                                 // columns a head (Dp / WIDE_DC)
  long long q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_sh;
  float scale;
  int e5m2;                      // fp8 caches (fp8_any): e5m2, else e4m3fn
  int qt;                        // q's and out's DType where EQ is q_as<M>
  int heads;                     // KV heads a segment (`kv_run`)
  int hx;                        // query heads a warp (`group_heads` / GC)
  // HEADS: KV heads a slot row holds (a multiple of `heads`: `run_box`), the
  // TMA box's extents over the head axis and across it (`box_n` runs of
  // `box_w` elements; dh and `heads` where one head's row is whole 16-byte
  // pieces), whether the producer warp copies by element in place of TMA,
  // and the bytes of one of its loads (`copy_width`)
  int box_heads, box_n, box_w, copy, width;
};

// fp8 caches of either kind are one load type, the kind an argument
// (`Args::e5m2`): one instantiation of each body serves both.
struct fp8_any {
  __nv_fp8_storage_t bits;
};

// q's and out's type where it is a launch argument (`Args::qt`: f32, bf16,
// f16, e4m3fn, e5m2), where q's type is not the caches' (fp8 caches: any
// float q): q is read in its own type and the output written in it. M is
// the type of the products: float (FMAs), or __half / __nv_bfloat16
// (mma.sync beside fp8 caches, `tensor_core_qk`).
template <typename M> struct q_as {};
template <typename EQ> struct QType {
  using mma = EQ;
  static constexpr bool runtime = false;
};
template <typename M> struct QType<q_as<M>> {
  using mma = M;
  static constexpr bool runtime = true;
};

// Elements i[e] of a tensor of type T (0 where !ok[e]), widened to fp32:
// every load issued before the first is used.
template <typename T, int N>
__device__ __forceinline__ void load_as(const void* p,
                                        const long long (&i)[N],
                                        const bool (&ok)[N], float (&out)[N]) {
  T v[N];
#pragma unroll
  for (int e = 0; e < N; ++e)
    v[e] = ok[e] ? static_cast<const T*>(p)[i[e]] : from_float<T>(0.f);
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] = to_float(v[e]);
}

// The same of q, whose type is EQ, or a.qt where EQ is q_as: one switch for
// the N loads, so that they are in flight together.
template <typename EQ, int N>
__device__ __forceinline__ void load_q(const void* p, const long long (&i)[N],
                                       const bool (&ok)[N], int qt,
                                       float (&out)[N]) {
  if constexpr (QType<EQ>::runtime) {
    switch (qt) {
      case DTYPE_BF16: load_as<__nv_bfloat16>(p, i, ok, out); break;
      case DTYPE_F16: load_as<__half>(p, i, ok, out); break;
      case DTYPE_E4M3:
      case DTYPE_E5M2: {
        const __nv_fp8_interpretation_t kind =
            qt == DTYPE_E5M2 ? __NV_E5M2 : __NV_E4M3;
        __nv_fp8_storage_t v[N];
#pragma unroll
        for (int e = 0; e < N; ++e)
          v[e] = ok[e] ? static_cast<const __nv_fp8_storage_t*>(p)[i[e]] : 0;
#pragma unroll
        for (int e = 0; e < N; ++e)
          out[e] = __half2float(__half(__nv_cvt_fp8_to_halfraw(v[e], kind)));
        break;
      }
      default: load_as<float>(p, i, ok, out);
    }
  } else {
    load_as<EQ>(p, i, ok, out);
  }
}

// x rounded into element i of a tensor of DType qt, as `from_float` rounds
// (fp8 by `to_fp8`: no saturation).
__device__ __forceinline__ void store_typed(void* p, long long i, float x,
                                            int qt) {
  switch (qt) {
    case DTYPE_BF16:
      static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
      break;
    case DTYPE_F16:
      static_cast<__half*>(p)[i] = __float2half_rn(x);
      break;
    case DTYPE_E4M3:
    case DTYPE_E5M2:
      static_cast<__nv_fp8_storage_t*>(p)[i] =
          to_fp8(x, qt == DTYPE_E5M2 ? __NV_E5M2 : __NV_E4M3);
      break;
    default:
      static_cast<float*>(p)[i] = x;
  }
}

// Two fp8 values (the low 16 bits of x, the first in the low byte) as two
// M in one register, the first in the low half. Exact: every e4m3fn and
// e5m2 value is a value of f16 and of bf16. An e5m2 byte is the high byte
// of the f16 of its value (a byte permute); e4m3fn takes the hardware's
// cvt.rn.f16x2.e4m3x2; bf16 is taken from the f16 through fp32.
template <typename M>
__device__ __forceinline__ uint32_t fp8x2_to(uint32_t x, int e5m2) {
  uint32_t h;
  if (e5m2) {
    h = __byte_perm(x, 0u, 0x1404);
  } else {
    const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)(x & 0xffffu), __NV_E4M3);
    h = (uint32_t)r.x | ((uint32_t)r.y << 16);
  }
  if constexpr (std::is_same_v<M, __half>) {
    return h;
  } else {
    __half2_raw r;
    r.x = (unsigned short)(h & 0xffffu);
    r.y = (unsigned short)(h >> 16);
    const __nv_bfloat162 b = __float22bfloat162_rn(__half22float2(__half2(r)));
    return *reinterpret_cast<const uint32_t*>(&b);
  }
}

// N cache elements from a slot, widened to fp32; fp8 of the kind KIND (0
// e4m3fn, 1 e5m2) or, at -1, of the launch's (`e5m2`): the FMA bodies'
// loops take the kind as KIND, which measured 13% faster at fp8 D = 8 than
// the launch's kind a conversion (PERF.md).
template <typename E, int N, int KIND = -1>
__device__ __forceinline__ void load_row(const E* p, float (&out)[N],
                                         int e5m2) {
  if constexpr (std::is_same_v<E, fp8_any>) {
    const Vec<E, N> x = *reinterpret_cast<const Vec<E, N>*>(p);
    const __nv_fp8_interpretation_t kind =
        KIND == 1 ? __NV_E5M2 : KIND == 0 ? __NV_E4M3
                  : e5m2 ? __NV_E5M2 : __NV_E4M3;
#pragma unroll
    for (int i = 0; i < N; ++i)
      out[i] = __half2float(__half(__nv_cvt_fp8_to_halfraw(x.v[i].bits,
                                                           kind)));
  } else {
    load_vec<E, N>(p, out);
  }
}

// N cache elements from a slot, widened, one element a load and 0 from
// element `valid` on: a row of the unpadded slots whose columns are no
// whole vectors of a lane (elsewhere `load_row` takes them as one vector).
template <typename E, int N>
__device__ __forceinline__ void load_cols(const E* p, float (&out)[N],
                                          int e5m2, int valid) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float y[1] = {0.f};
    if (i < valid) load_row<E, 1>(p + i, y, e5m2);
    out[i] = y[0];
  }
}

// Column c of a row of dh elements, or 0 past it: the padded body's loads.
template <typename E>
__device__ __forceinline__ E zero() {
  if constexpr (std::is_same_v<E, fp8_any>) return fp8_any{0};   // +0.0
  else return from_float<E>(0.f);
}

template <typename E>
__device__ __forceinline__ E col_or_zero(const E* row, int c, int dh) {
  return c < dh ? row[c] : zero<E>();
}

// A chunk's rows for the element copy (HEADS, a.copy): K and V from kr, vr
// (a row k_t / v_t bytes apart, a head k_h / v_h), each row `heads` heads
// of `units` loads of the copy's width, to [rows][heads][units] at kd, vd.
struct CopyRows {
  const unsigned char *kr, *vr;
  unsigned char *kd, *vd;
  long long k_t, k_h, v_t, v_h;
  int n, heads, units;
};

// The unit of the copy at i: its row, head and bytes from the head's start.
__device__ __forceinline__ void copy_unit_at(const CopyRows& c, int i, int w,
                                             long long& k_off,
                                             long long& v_off) {
  const int per = c.heads * c.units;
  const int r = i / per, rem = i - r * per, hh = rem / c.units;
  const int x = (rem - hh * c.units) * w;
  k_off = r * c.k_t + hh * c.k_h + x;
  v_off = r * c.v_t + hh * c.v_h + x;
}

// The producer warp's copy of a chunk, lane `lane` of 32, units of w bytes
// (every start, stride and the head's bytes multiples of w: `copy_width`),
// unit i to i w of its half, the unpadded layout; no zero column is
// written (the consumers read columns < dh only). Units of 4, 8 or 16
// bytes go by cp.async straight into place, no register held, and the
// lane's arrival on the slot's `full` barrier is made by their completion
// (cp.async.mbarrier.arrive.noinc), so the warp issues the next chunk's
// copies at once; narrower units (16-bit rows of odd D, fp8 rows of odd D)
// go byte by byte through registers, 16 of K and of V in flight a lane,
// and the lane arrives after its stores. One routine for every width: a
// copy instantiated a width held the kernels' registers at 56 with spills
// (ptxas; PERF.md).
__device__ __forceinline__ void copy_units(const CopyRows& c, int lane,
                                           int w, uint64_t* full) {
  const int per = c.heads * c.units, total = c.n * per;
  if (w >= 4) {
    const uint32_t kd = smem_u32(c.kd), vd = smem_u32(c.vd);
    // unit i = r per + rem, advanced by 32 as dr rows and drem units
    const int dr = 32 / per, drem = 32 % per;
    int r = lane / per, rem = lane % per;
    for (int i = lane; i < total; i += 32) {
      int hh = 0, xu = rem;
      if (c.heads > 1) {
        hh = rem / c.units;
        xu = rem - hh * c.units;
      }
      const long long ko = r * c.k_t + hh * c.k_h + xu * w;
      const long long vo = r * c.v_t + hh * c.v_h + xu * w;
      r += dr;
      rem += drem;
      if (rem >= per) {
        rem -= per;
        ++r;
      }
      const uint32_t at = (uint32_t)(i * w);
      if (w == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         kd + at), "l"(c.kr + ko) : "memory");
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         vd + at), "l"(c.vr + vo) : "memory");
      } else if (w == 8) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                         kd + at), "l"(c.kr + ko) : "memory");
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                         vd + at), "l"(c.vr + vo) : "memory");
      } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                         kd + at), "l"(c.kr + ko) : "memory");
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                         vd + at), "l"(c.vr + vo) : "memory");
      }
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                     "r"(smem_u32(full)) : "memory");
    return;
  }
  constexpr int U = 16;                     // loads in flight a tensor
  const int bytes = total * w;
  for (int i0 = lane; i0 < bytes; i0 += 32 * U) {
    unsigned char kx[U], vx[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + 32 * u;
      if (i < bytes) {
        long long ko, vo;
        copy_unit_at(c, i / w, w, ko, vo);
        kx[u] = c.kr[ko + i % w];
        vx[u] = c.vr[vo + i % w];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + 32 * u;
      if (i < bytes) {
        c.kd[i] = kx[u];
        c.vd[i] = vx[u];
      }
    }
  }
  mbar_arrive(full);                        // release: this lane's stores
}

// Barrier 1 over the NT consumer threads only (the producer warp runs on).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
}

// The same, returning whether `pred` held on any consumer thread.
__device__ __forceinline__ int consumers_or(int pred) {
  int any;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.s32 p, %1, 0;\n"
      "bar.red.or.pred q, 1, %2, p;\nselp.s32 %0, 1, 0, q;\n}\n"
      : "=r"(any)
      : "r"(pred), "n"(NT)
      : "memory");
  return any;
}

// atomicAdd(p, 1) with release and acquire semantics at GPU scope.
__device__ __forceinline__ int ticket_acq_rel(int* p) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// One step of a transpose reduction over a warp: lanes l and l ^ OFF swap
// the halves of part[0, 2 OFF) they do not keep and add. After the steps 16,
// 8, 4, 2, 1, lane r holds in part[0] the warp's sum of everyone's part[r].
// OFF is a template argument so that every index is known at compile time
// and part stays in registers.
template <int OFF>
__device__ __forceinline__ void transpose_sum(float (&part)[32], int lane) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = upper ? part[i] : part[i + OFF];
    const float keep = upper ? part[i + OFF] : part[i];
    part[i] = keep + __shfl_xor_sync(FULL, send, OFF);
  }
}

// N floats from L2 (ld.global.cg: the partials of other blocks, never a line
// this SM's L1 may hold from an earlier read), as one vector where N is 2 or
// 4, as two where N is 8 (D = 256: eight 4-byte loads a lane 32 bytes apart
// took 8 sectors of L2 an instruction where one is needed, and the merge of
// 16 heads' partials ran at a fraction of the L2's rate; PERF.md), as four
// where N is 16 (the tensor-core body at D = 512).
template <int N>
__device__ __forceinline__ void ldcg_vec(const float* p, float (&x)[N]) {
  if constexpr (N == 16) {               // the tensor-core body at D = 512
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 u = __ldcg(reinterpret_cast<const float4*>(p) + i);
      x[4 * i] = u.x; x[4 * i + 1] = u.y; x[4 * i + 2] = u.z;
      x[4 * i + 3] = u.w;
    }
  } else if constexpr (N == 8) {
    const float4 u = __ldcg(reinterpret_cast<const float4*>(p));
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p) + 1);
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
    x[4] = v.x; x[5] = v.y; x[6] = v.z; x[7] = v.w;
  } else if constexpr (N == 4) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
    x[0] = v.x; x[1] = v.y;
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) x[e] = __ldcg(p + e);
  }
}

// x to p[0, N): 16-byte stores where N is 8 or 16 (the partials at D =
// 256 and 512, as `ldcg_vec` reads them), else one a float.
template <int N>
__device__ __forceinline__ void st_vec(float* p, const float (&x)[N]) {
  if constexpr (N == 16) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  } else if constexpr (N == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) p[e] = x[e];
  }
}

// The segment holding global valid row g: s, the row t within it and the
// segment's end in the global order. P are the B + 1 prefix sums of the
// lengths, hg the segments a sequence. (`locate` in paged_attention.py.)
__device__ __forceinline__ void locate(const long long* P, int B, int hg,
                                       long long g, int& s, long long& t,
                                       long long& end) {
  int lo = 0, hi = B - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (P[mid] * hg <= g) lo = mid; else hi = mid - 1;
  }
  const long long n = P[lo + 1] - P[lo];
  const long long off = g - P[lo] * hg;
  const long long j = off / n;
  s = lo * hg + (int)j;
  t = off - j * n;
  end = P[lo] * hg + (j + 1) * n;
}

// What follows is shared by the ring body (`paged_attention_kernel`) and
// the wide body (`paged_wide_kernel`).
//
// A block's start: the ring's mbarriers (full: TMA's one arrival or the
// producer warp's 32 lanes; empty: the GC warps that read a slot), the
// tensor maps fetched while the lengths arrive, and by warp 0 the B + 1
// prefix sums of the lengths, each clamped to [0, T], into P.
__device__ __forceinline__ void block_start(const Args& a, uint64_t* full,
                                            uint64_t* empty, long long* P,
                                            bool tma, const CUtensorMap* kmap,
                                            const CUtensorMap* vmap) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < a.slots) {
    mbar_init(&full[tid], tma ? 1 : 32);
    mbar_init(&empty[tid], GC);
  }
  if (tma && tid == NT) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(kmap) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(vmap) : "memory");
  }
  if (tid < 32) {
    long long carry = 0;
    if (lane == 0) P[0] = 0;
    for (int base = 0; base < a.B; base += 32) {
      const int b = base + lane;
      long long x = b < a.B ? (long long)min(max(a.lengths[b], 0), a.T) : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const long long y = __shfl_up_sync(FULL, x, off);
        if (lane >= off) x += y;
      }
      if (b < a.B) P[b + 1] = carry + x;
      carry += __shfl_sync(FULL, x, 31);
    }
  }
  fence_barrier_init();
  __syncthreads();
}

// Where the query heads of segment s of one KV head are, `hs` a group
// (hg segments a sequence): sequence b, KV head h, first head g0, heads gn.
__device__ __forceinline__ void group_of(const Args& a, int hg, int hs,
                                         int s, int& b, int& h, int& g0,
                                         int& gn) {
  b = s / hg;
  const int j = s % hg;
  h = j / a.ngc;
  g0 = (j % a.ngc) * hs;
  gn = min(hs, a.G - g0);
}

// The first element of query head g0 + g of (b, h) in q and in out.
__device__ __forceinline__ long long q_index(const Args& a, int b, int h,
                                             int g0, int g) {
  return (long long)b * a.q_sb + ((long long)h * a.G + g0 + g) * a.q_sh;
}
__device__ __forceinline__ long long out_index(const Args& a, int b, int h,
                                               int g0, int g) {
  return (long long)b * a.o_sb + ((long long)h * a.G + g0 + g) * a.o_sh;
}

// Segments with no valid row (lengths[b] <= 0) get 0, as in the reference
// kernel: the blocks of the grid's first row, each every gridDim.x-th
// segment; heads(s, b, h, g0, gn) places a segment, put(i, x) writes out's
// element i, Dh columns a head.
template <typename Heads, typename Put>
__device__ __forceinline__ void zero_empty(const Args& a, const long long* P,
                                           int hg, int Dh, Heads heads,
                                           Put put) {
  if (blockIdx.y != 0) return;
  for (int s = blockIdx.x; s < a.B * hg; s += gridDim.x) {
    if (P[s / hg + 1] != P[s / hg]) continue;
    int b, h, g0, gn;
    heads(s, b, h, g0, gn);
    for (int i = threadIdx.x; i < gn * Dh; i += blockDim.x)
      put(out_index(a, b, h, g0, i / Dh) + i % Dh, 0.f);
  }
}

// The block's share of the W = P[B] hg valid rows of all segments laid end
// to end: rows [lo, hi), `per` = ceil(W / gridDim.x) a block.
__device__ __forceinline__ void block_share(const long long* P, int B, int hg,
                                            long long& per, long long& lo,
                                            long long& hi) {
  const long long W = P[B] * hg;
  per = (W + gridDim.x - 1) / gridDim.x;
  lo = min((long long)blockIdx.x * per, W);
  hi = min(lo + per, W);
}

// The blocks that share segment s of sequence b: the first and how many.
__device__ __forceinline__ void segment_blocks(const long long* P, int b,
                                               int hg, int s, long long per,
                                               long long& first, int& count) {
  const long long len = P[b + 1] - P[b];
  const long long start = P[b] * hg + (s % hg) * len;
  first = start / per;
  count = (int)((start + len - 1) / per - first + 1);
}

// The merge of segment s's partials once this block's is written (partial
// base + blockIdx.x - first of `parts`, `stride` floats each): one acq_rel
// ticket publishes it (release, cumulative over the barrier) and lets the
// last block see every other's (acquire); the last resets it for the next
// call and merges them by merge(m_lo, m_n, m_st, dst): partials m_lo + i
// m_st (i < m_n) into out, or into dst where dst is a partial. `grouped`
// and more than MERGE_GROUP blocks: two levels, the last of each group of
// MERGE_GROUP consecutive blocks merging the group's partials into its
// first (a ticket a group in `gtickets`, `ngroups` a segment), the last of
// those mergers the groups' into out.
template <typename Merge>
__device__ __forceinline__ void merge_partials(
    bool grouped, int count, long long first, long long base, int s,
    int* tickets, int* gtickets, int ngroups, float* parts, int stride,
    Merge merge) {
  consumers_sync();
  long long m_lo = base;
  int m_n = count, m_st = 1, last = 0;
  if (grouped && count > MERGE_GROUP) {
    const int grp = (int)(blockIdx.x - first) / MERGE_GROUP;
    const int gsize = min(MERGE_GROUP, count - grp * MERGE_GROUP);
    int* const gt = gtickets + (size_t)s * ngroups + grp;
    if (threadIdx.x == 0) {
      last = ticket_acq_rel(gt) == gsize - 1;
      if (last) atomicExch(gt, 0);
    }
    if (!consumers_or(last)) return;
    m_lo = base + (long long)grp * MERGE_GROUP;
    merge(m_lo, gsize, 1, parts + m_lo * stride);
    consumers_sync();                        // the group's partial is written
    m_lo = base;
    m_n = (count + MERGE_GROUP - 1) / MERGE_GROUP;
    m_st = MERGE_GROUP;
    last = 0;
  }
  if (threadIdx.x == 0) {
    last = ticket_acq_rel(&tickets[s]) == m_n - 1;
    if (last) atomicExch(&tickets[s], 0);
  }
  if (!consumers_or(last)) return;
  merge(m_lo, m_n, m_st, nullptr);
}

// Columns a block of the wide body (D > 256) owns, and the width of each of
// its K pieces.
constexpr int WIDE_DC = 256;
// The widest head the tensor-core body takes whole, a block over all its
// columns (16-bit caches under a q of their type above WIDE_DC: the note at
// the top); wider heads take the wide body's chunks.
constexpr int MMA_WIDE = 512;

// Elements of a row in one TMA box: at most 128 bytes.
template <typename E, int D>
__host__ __device__ constexpr int box_cols() {
  return D * (int)sizeof(E) > 128 ? 128 / (int)sizeof(E) : D;
}

// Q K^T and P V on the tensor cores (TMA bodies at D = Dp of 64 to 256, and
// at 512 for 16-bit caches under q of their type; not the wide body): bf16
// or f16 caches with q of their type, and fp8 caches with q as q_as<M>, M
// 16-bit (a bf16 q: bf16 products; f16 and fp8 q: f16
// products). TMA lays the boxes out under the swizzle of their row (128
// bytes; fp8 at D = 64, 64 bytes) so that ldmatrix reads 8 rows without
// bank conflicts. Other inputs take fp32 FMAs. (`products`: the host's rule.)
template <typename E, typename EQ, int D>
__host__ __device__ constexpr bool tensor_core_qk() {
  if constexpr (std::is_same_v<E, fp8_any>)
    return D >= 64 && sizeof(typename QType<EQ>::mma) == 2;
  else
    return sizeof(E) == 2 && D >= 64 && std::is_same_v<E, EQ>;
}

// Two 16-bit elements in one register, for the q fragments.
template <typename E> struct Pair2;
template <> struct Pair2<__nv_bfloat16> { using type = __nv_bfloat162; };
template <> struct Pair2<__half> { using type = __half2; };

// A block's shared memory, in bytes from its start: the kernel carves it
// and the launch sizes it from this one function. Two mbarriers a slot
// (loaded, released); the B + 1 prefix sums of the lengths; `comb`, set 1's
// (m, l, acc) of a warp's head handed to set 0 at a segment's end; `tacc`,
// a set's accumulators in rows of its HS = GC x HX query heads (TC; at HX
// 2 also the segment's q in 16 bits, [HS][D + QPAD]); `xch`, two exchange
// buffers a set (xch_floats(HS) each); then, from `ring` on the first
// 1024-byte boundary,
// the slots: K then V, each D / box_cols boxes of `rows` rows, a box
// rounded up to 1024 bytes as the TMA swizzle wants. (The wide body's:
// `wide_smem`.)
struct PagedSmem {
  int P, comb, tacc, xch, ring;  // offsets
  int box, slot;                 // bytes of a box and of a slot
  int bytes;                     // the whole, with 1024 to align the slots
};

// HEADS (a segment of `heads` KV heads): a half is one box of `rows` rows
// of all those heads' dh columns, [rows][heads][dh] unpadded and
// unswizzled, rounded up to 128 bytes.
template <typename E, int D, bool HEADS = false, int HX = 1>
__host__ __device__ PagedSmem paged_smem(int B, int rows, int slots,
                                         int heads = 1, int dh = D) {
  constexpr int IN = box_cols<E, D>();
  constexpr int HS = GC * HX;
  static_assert(HX == 1 || 2 * (D + QPAD) <= 4 * D, "q fits in tacc");
  PagedSmem m;
  m.P = round16(2 * slots * 8);
  m.comb = m.P + round16((B + 1) * 8);
  m.tacc = m.comb + 4 * GC * (D + 2);
  m.xch = m.tacc + 4 * NSET * HS * D;
  m.ring = m.xch + 4 * NSET * 2 * xch_floats(HS);
  if constexpr (HEADS) {
    m.box = (rows * heads * dh * (int)sizeof(E) + 127) & ~127;
    m.slot = 2 * m.box;
  } else {
    m.box = (rows * IN * (int)sizeof(E) + 1023) & ~1023;
    m.slot = 2 * (D / IN) * m.box;
  }
  m.bytes = m.ring + 1024 + slots * m.slot;
  return m;
}

// The deepest ring of at most MAX_SLOTS slots whose block fits in MAX_SMEM
// (one block an SM), and its bytes; 0 slots where none fits.
template <typename E, int D, bool HEADS = false, int HX = 1>
int ring_slots(int B, int rows, int* smem, int heads = 1, int dh = D) {
  for (int slots = MAX_SLOTS; slots >= 1; --slots) {
    *smem = paged_smem<E, D, HEADS, HX>(B, rows, slots, heads, dh).bytes;
    if (*smem <= MAX_SMEM) return slots;
  }
  return 0;
}

// The wide body (D > 256 on FMAs; the note at the top): the columns of a
// block, WIDE_PIECES pieces of WIDE_DC, the whole head up to 2048.
constexpr int WIDE_PIECES = 8;
constexpr int WIDE_NPW = WIDE_PIECES / NSET;   // pieces a warp takes at most
// The pieces a warp takes at a head of npk pieces (its accumulators').
__host__ __device__ constexpr int wide_npw(int npk) {
  return ((npk < WIDE_PIECES ? npk : WIDE_PIECES) + NSET - 1) / NSET;
}

// The wide body's shared memory, in bytes from its start: two mbarriers a
// slot (loaded, released), the B + 1 prefix sums of the lengths, the
// exchange of the logits' two parts (two buffers of [NSET][GC][32]
// floats), the consumer warps' accumulators ([warp][piece][lane][8]
// floats, `npw` pieces a warp: 16 KB a piece, 64 KB at 2048 columns, which
// 96 registers a thread do not hold beside Q K^T's 32 partial sums), then,
// from `ring` on the first 128-byte boundary, the
// slots: each one piece of K or of V, `rows` rows x WIDE_DC columns in
// boxes of box_cols columns, unswizzled, a box rounded up to 128 bytes.
struct WideSmem {
  int P, xch, acc, ring;         // offsets
  int box, slot;                 // bytes of a box and of a slot
  int bytes;                     // the whole, with 128 to align the slots
};

template <typename E>
__host__ __device__ WideSmem wide_smem(int B, int rows, int slots,
                                       int npw) {
  constexpr int IN = box_cols<E, WIDE_DC>();
  WideSmem m;
  m.P = round16(2 * slots * 8);
  m.xch = m.P + round16((B + 1) * 8);
  m.acc = m.xch + 4 * 2 * NSET * GC * 32;
  m.ring = m.acc + 4 * NSET * GC * npw * WIDE_DC;
  m.box = (rows * IN * (int)sizeof(E) + 127) & ~127;
  m.slot = (WIDE_DC / IN) * m.box;
  m.bytes = m.ring + 128 + slots * m.slot;
  return m;
}

// The deepest wide ring of at most MAX_SLOTS slots that fits in MAX_SMEM
// beside the accumulators of npw pieces a warp.
template <typename E>
int wide_ring_slots(int B, int rows, int npw, int* smem) {
  for (int slots = MAX_SLOTS; slots >= 1; --slots) {
    *smem = wide_smem<E>(B, rows, slots, npw).bytes;
    if (*smem <= MAX_SMEM) return slots;
  }
  return 0;
}


// Barrier 2 + set over the 8 warps of one consumer set.
__device__ __forceinline__ void set_sync(int set) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(2 + set), "n"(GC * 32) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The first two of r (lanes 0-15 give the addresses).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// The first two of r (lanes 0-15 give the addresses).
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// D += A B on 16-bit (E: bf16 or f16) m16n8k16 fragments (g = lane / 4,
// t = lane % 4): A (16x16, row): a0 = (g, 2t..2t+1) a1 = (g+8, 2t..)
// a2 = (g, 2t+8..) a3 = (g+8, 2t+8..); B (16x8, col): b0 = (k 2t..2t+1,
// n g), b1 = (k 2t+8.., n g); D: d0, d1 = (g, 2t..2t+1), d2, d3 = (g+8,
// 2t..2t+1).
template <typename E>
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
#define PAGED_MMA(TY)                                                     \
  asm volatile(                                                           \
      "mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 "          \
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
  if constexpr (std::is_same_v<E, __half>)
    PAGED_MMA("f16");
  else
    PAGED_MMA("bf16");
#undef PAGED_MMA
}

// E: the caches' type; EQ: q's and out's (E, or q_as<M> where q's type is
// another: a.qt); HEADS: a segment is a.heads KV heads of a
// sequence (the note at the top); HX: query heads a warp, 2 where a segment
// serves 16 of one KV head (the note at the top).
template <typename E, typename EQ, int D, bool EXACT, bool TMA,
          bool HEADS = false, int HX = 1>
__global__ void __launch_bounds__(NT + 32)
paged_attention_kernel(const Args a, const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap) {
  static_assert(!HEADS || TMA, "HEADS is a TMA ring's split");
  constexpr int ITEM = sizeof(E);
  constexpr int IN = box_cols<E, D>();       // columns of a box
  constexpr int NBX = D / IN;                // boxes a row
  constexpr int EPL = D >= 32 ? D / 32 : 1;  // columns a lane
  constexpr bool TC = TMA && !HEADS && tensor_core_qk<E, EQ, D>();
  constexpr bool F8 = std::is_same_v<E, fp8_any>;
  using M = std::conditional_t<F8, typename QType<EQ>::mma, E>;  // TC's type
  static_assert(HX == 1 || (TC && HX == 2), "two heads a warp: mma only");
  // q staged in the set's tacc and read by ldmatrix (HX 2, and the whole
  // head above WIDE_DC), else held as B fragments in registers
  constexpr bool QS = TC && (HX == 2 || D > WIDE_DC);
  constexpr int HS = GC * HX;                // query heads a segment serves
  constexpr int ROWB = IN * ITEM;            // bytes of a box's row
  const int Dh = EXACT ? D : a.dh;           // columns of q and out
  extern __shared__ __align__(1024) unsigned char smem[];
  const PagedSmem L =
      paged_smem<E, D, HEADS, HX>(a.B, a.rows, a.slots, a.box_heads, a.dh);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // a slot loaded
  uint64_t* empty = full + a.slots;                     // a slot released
  long long* P = reinterpret_cast<long long*>(smem + L.P);
  float* comb = reinterpret_cast<float*>(smem + L.comb);
  float* tacc = reinterpret_cast<float*>(smem + L.tacc);
  // a chunk's exchange between a set's warps (TC), two buffers a set: the
  // logits [HS][32] and P in two bf16 parts [HS][PSTR] (p = hi + lo, so that
  // P V on the tensor cores keeps fp32 accuracy), and each head's alpha
  float* xch = reinterpret_cast<float*>(smem + L.xch);
  unsigned char* slots = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem + L.ring) + 1023) & ~(uintptr_t)1023);
  const size_t box_bytes = L.box;
  const size_t half_bytes = HEADS ? box_bytes : NBX * box_bytes;   // K's
  const size_t slot_bytes = L.slot;
  // element (r, d) of a slot's K (or V) half; under the swizzle of rows of
  // ROWB bytes (TC) the 16-byte piece p of row r sits at p ^ (r % 8) (128)
  // or p ^ (r / 2 % 4) (64). HEADS: row r of the half's rows x heads rows
  // of dh columns (`kv_row`)
  auto at = [&](const unsigned char* half, int r, int d) {
    if constexpr (HEADS)
      return reinterpret_cast<const E*>(half +
                                        ((size_t)r * a.dh + d) * ITEM);
    const int byte = (d % IN) * ITEM;
    const int sw = ((r * ROWB) >> 7) & (ROWB / 16 - 1);
    const int in_row = TC ? ((((byte >> 4) ^ sw) << 4) | (byte & 15))
                          : byte;
    return reinterpret_cast<const E*>(half + (d / IN) * box_bytes +
                                      r * IN * ITEM + in_row);
  };

  // out's element i: of type EQ, or of a.qt (q_as)
  auto put = [&](long long i, float x) {
    if constexpr (QType<EQ>::runtime) store_typed(a.out, i, x, a.qt);
    else static_cast<EQ*>(a.out)[i] = from_float<EQ>(x);
  };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hw = warp % GC, set = warp / GC;   // a consumer's head and set
  // TMA loads the slots (the element rows' body: unless a.copy)
  const bool tma = TMA && !a.copy;
  // segments a sequence (HEADS: a.ngc is 1 where a segment has several KV
  // heads)
  const int hg = HEADS ? a.Hkv / a.heads * a.ngc : a.Hkv * a.ngc;
  // HEADS: this warp's query head hw is of the segment's hw / G-th KV head;
  // the columns a slot row holds
  const int kvh = HEADS ? hw / a.G : 0;
  const int dcols = HEADS ? a.dh : D;
  const int S = a.B * hg;
  float* const parts = a.part;
  // the segments' tickets, then (HX 2) a ticket a group of MERGE_GROUP
  // blocks of each segment
  const int ngroups = (gridDim.x + MERGE_GROUP - 1) / MERGE_GROUP;
  int* const tickets = a.tickets;
  int* const gtickets = tickets + S;

  block_start(a, full, empty, P, tma, &kmap, &vmap);

  // where segment s's query heads are (`group_of`); HEADS: the a.G query
  // heads of each of a.heads KV heads, or of one KV head a group of up to
  // HS as below
  auto heads = [&](int s, int& b, int& h, int& g0, int& gn) {
    if constexpr (HEADS) {
      b = s / hg;
      const int j = s % hg;
      h = j / a.ngc * a.heads;
      g0 = (j % a.ngc) * HS;
      gn = a.heads > 1 ? a.heads * a.G : min(HS, a.G - g0);
    } else {
      group_of(a, hg, HS, s, b, h, g0, gn);
    }
  };
  zero_empty(a, P, hg, Dh, heads, put);
  long long per, lo, hi;
  block_share(P, a.B, hg, per, lo, hi);
  if (lo >= hi) return;

  // aload of chunk j (the rows from global row g) into slot j % slots;
  // returns the global row after the chunk
  auto issue = [&](long long g, int j) -> long long {
    int s;
    long long t, end;
    locate(P, a.B, hg, g, s, t, end);
    int b, h, g0, gn;
    heads(s, b, h, g0, gn);
    unsigned char* dst = slots + (size_t)(j % a.slots) * slot_bytes;
    uint64_t* bar = &full[j % a.slots];
    if constexpr (HEADS) {      // rows x box_heads heads x dh: one box each
      const int c1 = h / a.box_heads * a.box_n;   // the run holding h
      mbar_arrive_expect_tx(
          bar, (uint32_t)(2 * a.rows * a.box_heads * a.dh * ITEM));
      tma_load_4d(dst, &kmap, bar, 0, c1, (int)t, b);
      tma_load_4d(dst + half_bytes, &vmap, bar, 0, c1, (int)t, b);
    } else {
      mbar_arrive_expect_tx(bar, (uint32_t)(2 * a.rows * D * ITEM));
#pragma unroll
      for (int x = 0; x < NBX; ++x) {
        tma_load_4d(dst + x * box_bytes, &kmap, bar, x * IN, h, (int)t, b);
        tma_load_4d(dst + half_bytes + x * box_bytes, &vmap, bar, x * IN, h,
                    (int)t, b);
      }
    }
    return g + min((long long)a.rows, min(end, hi) - g);
  };

  // the element copy's aload: the producer warp copies chunk j (the rows
  // from global row g) into slot j % slots, and each lane arrives; returns
  // the global row after the chunk: rows of a.box_heads heads of dh
  // columns, unpadded ([rows][heads][dh], as TMA lands a run), in loads of
  // a.width bytes (`copy_units`)
  auto copy = [&](long long g, int j) -> long long {
    int s;
    long long t, end;
    locate(P, a.B, hg, g, s, t, end);
    int b, h, g0, gn;
    heads(s, b, h, g0, gn);
    const int n = (int)min((long long)a.rows, min(end, hi) - g);
    unsigned char* dst = slots + (size_t)(j % a.slots) * slot_bytes;
    const int hb = h - h % a.box_heads;       // the slot's first KV head
    const unsigned char* kr = static_cast<const unsigned char*>(a.k) +
                              (b * a.k_sb + t * a.k_st + hb * a.k_sh) * ITEM;
    const unsigned char* vr = static_cast<const unsigned char*>(a.v) +
                              (b * a.v_sb + t * a.v_st + hb * a.v_sh) * ITEM;
    const CopyRows c{kr, vr, dst, dst + half_bytes, a.k_st * ITEM,
                     a.k_sh * ITEM, a.v_st * ITEM, a.v_sh * ITEM, n,
                     a.box_heads, a.dh * ITEM / a.width};
    copy_units(c, lane, a.width, &full[j % a.slots]);
    return g + n;
  };

  if (warp == NSET * GC) {      // the producer: every chunk of the share,
    if (tma) {                  // a slot as soon as the consumers free it
      if (lane == 0) {
        long long g = lo;
        for (int j = 0; g < hi; ++j) {
          if (j >= a.slots)
            mbar_wait(&empty[j % a.slots], (uint32_t)((j / a.slots - 1) & 1));
          g = issue(g, j);
        }
      }
    } else if constexpr (HEADS) {   // all 32 lanes copy
      long long g = lo;
      for (int j = 0; g < hi; ++j) {
        if (j >= a.slots)
          mbar_wait(&empty[j % a.slots], (uint32_t)((j / a.slots - 1) & 1));
        g = copy(g, j);
      }
    }
    return;
  }

  const int d0 = lane * EPL;
  // a warp's query heads: hw of the segment's group and, at HX 2, hw + GC
  float m[HX], l[HX], acc[HX][EPL], qr[EPL];
  uint32_t qb[TC && !QS ? D / 16 : 1][2];   // Q as mma B fragments (TC)
  constexpr int NCOL = D / GC;               // P V columns a warp (TC)
  // fp8: a warp's columns are whole 16-byte rows of ldmatrix, so at D = 64
  // the first 4 warps take 16 columns each
  constexpr int PVC = F8 && NCOL < 16 ? 16 : NCOL;
  constexpr int PVW = D / PVC;               // warps that take P V (TC)
  constexpr int NTW = TC ? PVC / 8 : 1;      // a warp's mma n-tiles
  float cacc[NTW][4];                        // its P V accumulators (TC)
  int cur = -1, b = 0, h = 0, g0 = 0, gn = 0;
  // HEADS: the slot row of chunk row r for this warp's query head (rows of
  // a.box_heads KV heads from the slot's first, this warp's KV head `hoff`
  // on: set at each segment); whether a lane's EPL columns of it are one
  // aligned vector
  int hoff = 0;
  auto kv_row = [&](int r) { return HEADS ? r * a.box_heads + hoff : r; };
  const bool vrow = !HEADS || a.dh % EPL == 0;
  // QS: the segment's q in M, [HS][D + QPAD], in the set's tacc
  const M* const q16 = reinterpret_cast<const M*>(tacc + set * HS * D);

  // set 1's (m, l, acc) of query head qh (this warp's) into set 0's, through
  // shared memory
  auto hand_over = [&](float& m_, float& l_, float (&acc_)[EPL], int qh) {
    float* c = comb + hw * (D + 2);
    if (set == 1 && qh < gn) {
      if (lane == 0) {
        c[0] = m_;
        c[1] = l_;
      }
      if (d0 < D) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) c[2 + d0 + e] = acc_[e];
      }
    }
    consumers_sync();
    if (set == 0 && qh < gn) {
      const float m1 = c[0], mx = fmaxf(m_, m1);
      const float w0 = expf(m_ - mx), w1 = expf(m1 - mx);
      l_ = l_ * w0 + c[1] * w1;
      if (d0 < D) {
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc_[e] = acc_[e] * w0 + c[2 + d0 + e] * w1;
      }
      m_ = mx;
    }
    consumers_sync();                        // comb is free again
  };

  // the block's share of segment `cur` is done: write it or merge it
  auto finish = [&]() {
    if constexpr (TC) {          // the set's accumulators to rows of heads
      float* ta = tacc + set * HS * D;
      const int gq = lane >> 2, tq = lane & 3;
      if (!F8 || hw < PVW) {          // (every warp but fp8's at D = 64)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
          for (int x = 0; x < HX; ++x) {     // rows gq and (HX 2) gq + 8
            float* tr = ta + (gq + 8 * x) * D;
            if constexpr (F8) {   // n-tile nt: columns of parity nt % 2 (P V)
              const int col = hw * PVC + 16 * (nt >> 1) + 4 * tq + (nt & 1);
              tr[col] = cacc[nt][2 * x];
              tr[col + 2] = cacc[nt][2 * x + 1];
            } else {
              const int col = hw * NCOL + nt * 8 + 2 * tq;
              tr[col] = cacc[nt][2 * x];
              tr[col + 1] = cacc[nt][2 * x + 1];
            }
          }
        }
      }
      set_sync(set);
      if constexpr (HX == 1) {
        if (d0 < D) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[0][e] = ta[hw * D + d0 + e];
        }
        set_sync(set);
      }
    }
    // a warp's head x (hw + GC x) merged over the two sets, at HX 2 its
    // accumulators read from the set's rows of heads first, so that one
    // head's are live at a time (the rows stay until the next segment's q)
    auto merged = [&](int x) {
      if constexpr (TC && HX == 2) {
        const float* ta = tacc + set * HS * D;
        if (d0 < D) {
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            acc[x][e] = ta[(hw + GC * x) * D + d0 + e];
        }
      }
      hand_over(m[x], l[x], acc[x], hw + GC * x);
    };
    long long first;
    int count;
    segment_blocks(P, b, hg, cur, per, first, count);
    if (count == 1) {                        // the block holds it alone
#pragma unroll
      for (int x = 0; x < HX; ++x) {
        merged(x);
        if (set == 0 && hw + GC * x < gn && d0 < D) {
          const long long o = out_index(a, b, h, g0, hw + GC * x) + d0;
          const float inv = 1.f / fmaxf(l[x], 1e-30f);
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            if (EXACT || d0 + e < Dh) put(o + e, acc[x][e] * inv);
        }
      }
      return;
    }
    constexpr int STRIDE = HS * (D + 2);
    const long long base = first + cur;      // the segment's partials
    float* mine = parts + (base + blockIdx.x - first) * STRIDE;
#pragma unroll
    for (int x = 0; x < HX; ++x) {
      const int qh = hw + GC * x;
      merged(x);
      if (set == 0 && qh < gn) {
        if (lane == 0) {
          mine[qh] = m[x];
          mine[HS + qh] = l[x];
        }
        if (d0 < D) st_vec<EPL>(mine + 2 * HS + qh * D + d0, acc[x]);
      }
    }
    // merges pieces m_lo + k m_st (k < m_n) of the workspace, lanes over
    // them, into out or (dst) into one partial: at HX 1 each set half of
    // them, a warp its head, the halves then handed over; at HX 2 set s the
    // heads hw + GC s over all of them (no hand-over)
    auto merge = [&](long long m_lo, int m_n, int m_st, float* dst) {
      const int half = HX == 2 ? m_n : (m_n + 1) / 2;
      const bool first_half = set == 0 || HX == 2;
      const long long p_lo = m_lo + (long long)(first_half ? 0 : half) * m_st;
      const int np_all = first_half ? half : m_n - half;
      auto piece = [&](int p) {
        return parts + (p_lo + (long long)p * m_st) * STRIDE;
      };
      {
        const int qh = hw + (HX == 2 ? GC * set : 0);
        float mx = NEG_INF, ls = 0.f, as[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) as[e] = 0.f;
        if (qh < gn) {
          // partials a batch: at HX 1 4 (8 or 16 spill at D = 256), 2 at D
          // = 512; at HX 2 (a warp's one head over all of a group's 8 or of
          // the groups) 32 columns' worth, 4 to 8
          constexpr int NB = HX == 2 ? (EPL >= 8 ? 4 : 8) : EPL > 8 ? 2 : 4;
          float xp[NB][EPL];                 // NB partials' columns
          auto load_batch = [&](int p0) {
#pragma unroll
            for (int i = 0; i < NB; ++i) {
              if (p0 + i < np_all && d0 < D) {
                ldcg_vec<EPL>(piece(p0 + i) + 2 * HS + qh * D + d0, xp[i]);
              } else {
#pragma unroll
                for (int e = 0; e < EPL; ++e) xp[i][e] = 0.f;
              }
            }
          };
          load_batch(0);                     // in flight with (m, l) below
          float pm[2], pl[2];                // pieces lane and lane + 32
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int p = lane + 32 * r;
            pm[r] = p < np_all ? __ldcg(piece(p) + qh) : NEG_INF;
            pl[r] = p < np_all ? __ldcg(piece(p) + HS + qh) : 0.f;
          }
          for (int p = lane + 64; p < np_all; p += 32)
            mx = fmaxf(mx, __ldcg(piece(p) + qh));
          mx = warp_max(fmaxf(mx, fmaxf(pm[0], pm[1])));
          float w = 0.f;                     // the weight of piece p0 + lane
          for (int p0 = 0; p0 < np_all; p0 += NB) {
            if (p0 % 32 == 0) {
              const int p = p0 + lane;
              const float m_p = p0 < 64 ? pm[p0 >> 5]
                                        : (p < np_all ? __ldcg(piece(p) + qh)
                                                      : NEG_INF);
              const float l_p = p0 < 64 ? pl[p0 >> 5]
                                        : (p < np_all
                                               ? __ldcg(piece(p) + HS + qh)
                                               : 0.f);
              w = p < np_all ? expf(m_p - mx) : 0.f;
              ls = fmaf(l_p, w, ls);
            }
            if (p0 > 0) load_batch(p0);
#pragma unroll
            for (int i = 0; i < NB; ++i) {   // xp is 0 past the last piece
              const float wi = __shfl_sync(FULL, w, (p0 % 32) + i);
#pragma unroll
              for (int e = 0; e < EPL; ++e) as[e] = fmaf(xp[i][e], wi, as[e]);
            }
          }
          ls = warp_sum(ls);
        }
        if constexpr (HX == 1) hand_over(mx, ls, as, qh);
        if (first_half && qh < gn && d0 < D) {
          if (dst) {                         // a partial: (m, l, acc)
            if (lane == 0) {
              dst[qh] = mx;
              dst[HS + qh] = ls;
            }
            st_vec<EPL>(dst + 2 * HS + qh * D + d0, as);
          } else {
            const long long o = out_index(a, b, h, g0, qh) + d0;
            const float inv = 1.f / fmaxf(ls, 1e-30f);
#pragma unroll
            for (int e = 0; e < EPL; ++e)
              if (EXACT || d0 + e < Dh) put(o + e, as[e] * inv);
          }
        }
      }
    };
    // the block's partial is written: merged, in two levels where 16 heads
    // make a partial or D columns above WIDE_DC (the note at the top)
    merge_partials(HX == 2 || D > WIDE_DC, count, first, base, cur, tickets,
                   gtickets, ngroups, parts, STRIDE, merge);
  };

  long long g = lo;
  for (int j = 0; g < hi; ++j) {
    int s;
    long long t, end;
    locate(P, a.B, hg, g, s, t, end);
    const int n = (int)min((long long)a.rows, min(end, hi) - g);
    if (s != cur) {                          // a new segment: its queries
      if (cur >= 0) finish();
      cur = s;
      heads(s, b, h, g0, gn);
      hoff = h % a.box_heads + kvh;
      // (TC, q of a launch's type) the group's queries, columns past Dh and
      // heads past gn as zeros, staged in fp32 in the set's tacc by all its
      // threads, EPL loads in flight each, for the fragments below
      float* const qs = tacc + set * HS * D;
      if constexpr (TC && QType<EQ>::runtime && !QS) {
        long long qi[EPL];
        bool ok[EPL];
        float qv[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int i = hw * 32 + lane + e * GC * 32, g = i / D, c = i % D;
          qi[e] = q_index(a, b, h, g0, g) + c;
          ok[e] = g < gn && c < Dh;
        }
        load_q<EQ, EPL>(a.q, qi, ok, a.qt, qv);
#pragma unroll
        for (int e = 0; e < EPL; ++e) qs[hw * 32 + lane + e * GC * 32] = qv[e];
        set_sync(set);
      }
      if constexpr (QS) {
        // the group's HS queries in M, [HS][D + QPAD], warp w of the set
        // its heads w and w + GC, a lane EPL columns of each, columns past
        // Dh and heads past gn as zeros; for fp8 caches in their k order
        // (an A fragment's columns 4t .. 4t + 3 at 2t, 2t + 1, 2t + 8, 2t +
        // 9): column 4t + r of each 16 at 2t + r (r < 2) or 8 + 2t + r - 2,
        // so that one ldmatrix gives both n-tiles' B fragments of a k-step
        M* const qw = reinterpret_cast<M*>(qs);
#pragma unroll
        for (int x = 0; x < HX; ++x) {
          const int g = hw + GC * x;
          float qv[EPL];
          if (g < gn) {
            const long long qh = q_index(a, b, h, g0, g) + d0;
            if constexpr (EXACT) {
              load_vec<EQ, EPL>(static_cast<const EQ*>(a.q) + qh, qv);
            } else {
              long long qi[EPL];
              bool ok[EPL];
#pragma unroll
              for (int e = 0; e < EPL; ++e) {
                qi[e] = qh + e;
                ok[e] = d0 + e < Dh;
              }
              load_q<EQ, EPL>(a.q, qi, ok, a.qt, qv);
            }
          } else {
#pragma unroll
            for (int e = 0; e < EPL; ++e) qv[e] = 0.f;
          }
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            const int c = d0 + e, r = c & 3, t = (c >> 2) & 3;
            const int at16 =
                F8 ? (c & ~15) | ((r & 2) << 2) | (t << 1) | (r & 1) : c;
            qw[g * (D + QPAD) + at16] = from_float<M>(qv[e]);
          }
        }
        set_sync(set);
      }
      if constexpr (TC && !QS) if (hw < 2) {  // B fragments: the queries
        const int gq = lane >> 2, tq = lane & 3;
        const long long qg = q_index(a, b, h, g0, gq);
        auto pair = [&](int c) -> uint32_t {   // columns c, c + 1, in M
          if (gq >= gn) return 0u;
          typename Pair2<M>::type p;
          if constexpr (QType<EQ>::runtime) {
            p.x = from_float<M>(qs[gq * D + c]);
            p.y = from_float<M>(qs[gq * D + c + 1]);
          } else if constexpr (EXACT) {
            return *reinterpret_cast<const uint32_t*>(
                static_cast<const EQ*>(a.q) + qg + c);
          } else {                           // past D: zeros
            const E* qr0 = static_cast<const EQ*>(a.q) + qg;
            p.x = col_or_zero(qr0, c, Dh);
            p.y = col_or_zero(qr0, c + 1, Dh);
          }
          return *reinterpret_cast<uint32_t*>(&p);
        };
        // an mma's k order follows its A fragment: 16-bit K rows give a lane
        // columns 2t, 2t + 1 and 2t + 8, 2t + 9; fp8 rows, read as b16,
        // columns 4t .. 4t + 3 (Q K^T below)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int k0 = kk * 16 + (F8 ? 4 * tq : 2 * tq);
          qb[kk][0] = pair(k0);
          qb[kk][1] = pair(k0 + (F8 ? 2 : 8));
        }
      }
      if constexpr (TC && QType<EQ>::runtime && !QS)
        set_sync(set);                       // qs is free
      // the warp's query, a lane's part
      if (hw < gn && d0 < D) {
        const long long qh = q_index(a, b, h, g0, hw);
        if constexpr (EXACT) {
          float qv[EPL];
          load_vec<EQ, EPL>(static_cast<const EQ*>(a.q) + qh + d0, qv);
#pragma unroll
          for (int e = 0; e < EPL; ++e) qr[e] = qv[e];
        } else {
          long long qi[EPL];
          bool ok[EPL];
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            qi[e] = qh + d0 + e;
            ok[e] = d0 + e < Dh;
          }
          load_q<EQ, EPL>(a.q, qi, ok, a.qt, qr);
        }
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) qr[e] = 0.f;
      }
#pragma unroll
      for (int x = 0; x < HX; ++x) {
        m[x] = NEG_INF;
        l[x] = 0.f;
        if constexpr (!TC || D <= WIDE_DC) {   // (above: `finish` sets it)
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[x][e] = 0.f;
        }
      }
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
        cacc[nt][0] = cacc[nt][1] = cacc[nt][2] = cacc[nt][3] = 0.f;
    }
    g += n;
    if (j % NSET != set) continue;           // the other set's chunk
    const unsigned char* slot = slots + (size_t)(j % a.slots) * slot_bytes;
    mbar_wait(&full[j % a.slots], (uint32_t)((j / a.slots) & 1));  // getfin
    float sc[HX];                            // row `lane`'s logit, a head
#pragma unroll
    for (int x = 0; x < HX; ++x) sc[x] = NEG_INF;
    if constexpr (TC) {  // Q K^T: warps 0 and 1 of the set, 16 rows each
      float* lg = xch + (set * 2 + ((j / NSET) & 1)) * xch_floats(HS);
      if (hw < 2 && hw * 16 < n) {
        const int mi = lane >> 3, ri = lane & 7;
        const int row = min(hw * 16 + (mi & 1) * 8 + ri, a.rows - 1);
        float c[HX][4] = {};
        // the B fragments of k-step kk, an n-tile of 8 query heads each:
        // from q's registers, or (QS) from the staged q by one ldmatrix,
        // lane l giving row l % 8 of matrix l / 8: heads 0-7 at the
        // k-step's columns 0-7 and 8-15, then (HX 2) heads 8-15 at the same
        const int qrow = (mi >> 1) * 8 + ri;   // QS: its head in the group
        auto qfrag = [&](int kk, uint32_t (&bq)[HX][2]) {
          if constexpr (!QS) {
            bq[0][0] = qb[kk][0];
            bq[0][1] = qb[kk][1];
          } else if constexpr (HX == 1) {
            uint32_t r[4];
            ldmatrix_x2(r, q16 + qrow * (D + QPAD) + kk * 16 + (mi & 1) * 8);
            bq[0][0] = r[0];
            bq[0][1] = r[1];
          } else {
            uint32_t r[4];
            ldmatrix_x4(r, q16 + qrow * (D + QPAD) + kk * 16 + (mi & 1) * 8);
            bq[0][0] = r[0];
            bq[0][1] = r[1];
            bq[1][0] = r[2];
            bq[1][1] = r[3];
          }
        };
        if constexpr (F8) {
          // 32 fp8 columns an ldmatrix, the rows read as b16: kf[0] = row g,
          // columns 4t .. 4t + 3; kf[1] the same of row g + 8; kf[2], kf[3]
          // those 16 columns on. Each pair of them is the A of one mma, its
          // bytes 0-1 as (2t, 2t + 1) and 2-3 as (2t + 8, 2t + 9)
          const int k_e5m2 = a.e5m2;               // K's fp8 kind
#pragma unroll
          for (int k2 = 0; k2 < D / 32; ++k2) {
            uint32_t kf[4];
            ldmatrix_x4(kf, at(slot, row, k2 * 32 + (mi >> 1) * 16));
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const uint32_t af[4] = {
                  fp8x2_to<M>(kf[2 * hf], k_e5m2),
                  fp8x2_to<M>(kf[2 * hf + 1], k_e5m2),
                  fp8x2_to<M>(kf[2 * hf] >> 16, k_e5m2),
                  fp8x2_to<M>(kf[2 * hf + 1] >> 16, k_e5m2)};
              uint32_t bq[HX][2];
              qfrag(2 * k2 + hf, bq);
#pragma unroll
              for (int x = 0; x < HX; ++x)
                mma_16816<M>(c[x], af, bq[x][0], bq[x][1]);
            }
          }
        } else if constexpr (D > WIDE_DC) {
          // the whole head (HX 1): the even k-steps and the odd ones in two
          // chains of mma, added at the end
          float c2[4] = {};
#pragma unroll
          for (int kk = 0; kk < D / 16; kk += 2) {
            uint32_t af[4], af2[4], bq[HX][2], bq2[HX][2];
            ldmatrix_x4(af, at(slot, row, kk * 16 + (mi >> 1) * 8));
            ldmatrix_x4(af2, at(slot, row, kk * 16 + 16 + (mi >> 1) * 8));
            qfrag(kk, bq);
            qfrag(kk + 1, bq2);
            mma_16816<E>(c[0], af, bq[0][0], bq[0][1]);
            mma_16816<E>(c2, af2, bq2[0][0], bq2[0][1]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) c[0][i] += c2[i];
        } else {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t af[4], bq[HX][2];
            ldmatrix_x4(af, at(slot, row, kk * 16 + (mi >> 1) * 8));
            qfrag(kk, bq);
#pragma unroll
            for (int x = 0; x < HX; ++x)
              mma_16816<E>(c[x], af, bq[x][0], bq[x][1]);
          }
        }
        // n-tile x: head 8 x + 2 t (and + 1) of rows r0 and r0 + 8
        const int gq = lane >> 2, tq = lane & 3, r0 = hw * 16 + gq;
#pragma unroll
        for (int x = 0; x < HX; ++x) {
          float* lx = lg + (8 * x + 2 * tq) * 32;
          lx[r0] = c[x][0];
          lx[32 + r0] = c[x][1];
          lx[r0 + 8] = c[x][2];
          lx[32 + r0 + 8] = c[x][3];
        }
      }
      set_sync(set);
#pragma unroll
      for (int x = 0; x < HX; ++x)
        if (lane < n) sc[x] = lg[(hw + GC * x) * 32 + lane] * a.scale;
    }
    float alpha[HX], p[HX];
#pragma unroll
    for (int x = 0; x < HX; ++x) {
      alpha[x] = 1.f;
      p[x] = 0.f;
      if (hw + GC * x >= gn) continue;
      if constexpr (!TC) {   // Q K^T on FMAs: a lane's columns, every row
        float part[32];
        if (vrow) {
          auto qk_rows = [&](auto kind) {
#pragma unroll
            for (int r = 0; r < 32; ++r) {
              float dot = 0.f;
              if (r < n && d0 < dcols) {
                float kv[EPL];
                load_row<E, EPL, decltype(kind)::value>(
                    at(slot, kv_row(r), d0), kv, a.e5m2);
#pragma unroll
                for (int e = 0; e < EPL; ++e) dot = fmaf(qr[e], kv[e], dot);
              }
              part[r] = dot;
            }
          };
          if constexpr (F8) {
            if (a.e5m2) qk_rows(std::integral_constant<int, 1>{});
            else qk_rows(std::integral_constant<int, 0>{});
          } else {
            qk_rows(std::integral_constant<int, -1>{});
          }
        } else {                // HEADS rows of no whole vectors of a lane
#pragma unroll
          for (int r = 0; r < 32; ++r) {
            float dot = 0.f;
            if (r < n && d0 < dcols) {
              float kv[EPL];
              load_cols<E, EPL>(at(slot, kv_row(r), d0), kv, a.e5m2,
                                dcols - d0);
#pragma unroll
              for (int e = 0; e < EPL; ++e) dot = fmaf(qr[e], kv[e], dot);
            }
            part[r] = dot;
          }
        }
        transpose_sum<16>(part, lane);       // lane r: the sum of row r
        transpose_sum<8>(part, lane);
        transpose_sum<4>(part, lane);
        transpose_sum<2>(part, lane);
        transpose_sum<1>(part, lane);
        if (lane < n) sc[x] = part[0] * a.scale;
      }
      const float m_new = fmaxf(m[x], warp_max(sc[x]));
      alpha[x] = expf(m[x] - m_new);
      p[x] = lane < n ? expf(sc[x] - m_new) : 0.f;
      l[x] = fmaf(l[x], alpha[x], warp_sum(p[x]));
      m[x] = m_new;
      if constexpr (!TC) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[x][e] *= alpha[x];
        if (vrow) {
          auto pv_rows = [&](auto kind) {
#pragma unroll 8
            for (int r = 0; r < n; ++r) {    // P V: a lane D/32 columns
              const float pr = __shfl_sync(FULL, p[x], r);
              if (d0 < dcols) {
                float vv[EPL];
                load_row<E, EPL, decltype(kind)::value>(
                    at(slot + half_bytes, kv_row(r), d0), vv, a.e5m2);
#pragma unroll
                for (int e = 0; e < EPL; ++e)
                  acc[x][e] = fmaf(pr, vv[e], acc[x][e]);
              }
            }
          };
          if constexpr (F8) {
            if (a.e5m2) pv_rows(std::integral_constant<int, 1>{});
            else pv_rows(std::integral_constant<int, 0>{});
          } else {
            pv_rows(std::integral_constant<int, -1>{});
          }
        } else {
#pragma unroll 8
          for (int r = 0; r < n; ++r) {
            const float pr = __shfl_sync(FULL, p[x], r);
            if (d0 < dcols) {
              float vv[EPL];
              load_cols<E, EPL>(at(slot + half_bytes, kv_row(r), d0), vv,
                                a.e5m2, dcols - d0);
#pragma unroll
              for (int e = 0; e < EPL; ++e)
                acc[x][e] = fmaf(pr, vv[e], acc[x][e]);
            }
          }
        }
      }
    }
    if constexpr (TC) {  // P V on the tensor cores: warp w, columns w NCOL..
      float* xb = xch + (set * 2 + ((j / NSET) & 1)) * xch_floats(HS);
      M* ph = reinterpret_cast<M*>(xb + HS * 32);
      M* pl = ph + HS * PSTR;
      float* al = xb + HS * 32 + HS * PSTR;
#pragma unroll
      for (int x = 0; x < HX; ++x) {
        const int qh = hw + GC * x;
        const M hi = from_float<M>(p[x]);    // p = hi + lo
        ph[qh * PSTR + lane] = hi;
        pl[qh * PSTR + lane] = from_float<M>(p[x] - to_float(hi));
        if (lane == 0) al[qh] = alpha[x];
      }
      set_sync(set);
      const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int x = 0; x < HX; ++x) {         // rows gq and (HX 2) gq + 8
        const float sa = al[gq + 8 * x];
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          cacc[nt][2 * x] *= sa;
          cacc[nt][2 * x + 1] *= sa;
        }
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {       // 16 rows a k-step
        if (ks * 16 >= n) break;
        // A = P [heads g, g + 8 (HX 1: zero)][rows]: a0 = (g, 2t..), a1 =
        // (g + 8, 2t..), a2 = (g, 2t+8..), a3 = (g + 8, 2t+8..)
        const int pk = gq * PSTR + ks * 16 + 2 * tq;
        auto word = [](const M* x) {
          return *reinterpret_cast<const uint32_t*>(x);
        };
        constexpr int P8 = 8 * PSTR;         // heads g + 8 (HX 2)
        const uint32_t ahi[4] = {
            word(ph + pk), HX == 2 ? word(ph + pk + P8) : 0u,
            word(ph + pk + 8), HX == 2 ? word(ph + pk + P8 + 8) : 0u};
        const uint32_t alo[4] = {
            word(pl + pk), HX == 2 ? word(pl + pk + P8) : 0u,
            word(pl + pk + 8), HX == 2 ? word(pl + pk + P8 + 8) : 0u};
        const int mi = lane >> 3, ri = lane & 7;
        const int row = min(ks * 16 + (mi & 1) * 8 + ri, a.rows - 1);
        if constexpr (F8) {
          // B = V by ldmatrix.trans of the fp8 rows read as b16: rows 8
          // (mi & 1) + ri of the k-step, columns 16 (mi >> 1) of the
          // warp's. vf[2 j] holds, for the lane's byte pair (columns 2g,
          // 2g + 1 of the 16 from 16 j), rows 2t and 2t + 1; vf[2 j + 1]
          // rows 2t + 8, 2t + 9. A byte permute pairs each column's two rows
          // (bytes 0, 2 and 1, 3): n-tile 2 j takes the even columns, 2 j
          // + 1 the odd ones (`finish` puts them back in order)
          if (hw < PVW) {
            uint32_t vf[4];
            const void* vp =
                at(slot + half_bytes, row, hw * PVC + (mi >> 1) * 16);
            if constexpr (PVC == 32) ldmatrix_x4_trans(vf, vp);
            else ldmatrix_x2_trans(vf, vp);
#pragma unroll
            for (int nt = 0; nt < NTW; ++nt) {
              const uint32_t sel = nt & 1 ? 0x3131u : 0x2020u;
              const uint32_t b0 = fp8x2_to<M>(
                  __byte_perm(vf[2 * (nt >> 1)], 0u, sel), a.e5m2);
              const uint32_t b1 = fp8x2_to<M>(
                  __byte_perm(vf[2 * (nt >> 1) + 1], 0u, sel), a.e5m2);
              mma_16816<M>(cacc[nt], ahi, b0, b1);
              mma_16816<M>(cacc[nt], alo, b0, b1);
            }
          }
        } else {
          // B = V [rows][columns] by ldmatrix.trans: rows 8 (mi & 1) + ri of
          // the k-step, columns 8 (mi >> 1) of the warp's
          if constexpr (NTW > 4) {    // D = 512: 16 columns a load, each
                                      // taken by its two n-tiles at once
#pragma unroll
            for (int i = 0; i < NTW / 2; ++i) {
              uint32_t b4[4];
              ldmatrix_x4_trans(b4, at(slot + half_bytes, row,
                                       hw * NCOL + 16 * i + (mi >> 1) * 8));
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                mma_16816<E>(cacc[2 * i + h], ahi, b4[2 * h], b4[2 * h + 1]);
                mma_16816<E>(cacc[2 * i + h], alo, b4[2 * h], b4[2 * h + 1]);
              }
            }
          } else {
            const E* vp =
                at(slot + half_bytes, row, hw * NCOL + (mi >> 1) * 8);
            uint32_t bv[NTW > 2 ? 2 * NTW : 4];
            if constexpr (NTW == 4) {          // D = 256: columns +0 and +16
              ldmatrix_x4_trans(*reinterpret_cast<uint32_t(*)[4]>(&bv[0]),
                                vp);
              ldmatrix_x4_trans(*reinterpret_cast<uint32_t(*)[4]>(&bv[4]),
                                at(slot + half_bytes, row,
                                   hw * NCOL + 16 + (mi >> 1) * 8));
            } else if constexpr (NTW == 2) {
              ldmatrix_x4_trans(bv, vp);
            } else {
              ldmatrix_x2_trans(bv, vp);
            }
#pragma unroll
            for (int nt = 0; nt < NTW; ++nt) {
              mma_16816<E>(cacc[nt], ahi, bv[2 * nt], bv[2 * nt + 1]);
              mma_16816<E>(cacc[nt], alo, bv[2 * nt], bv[2 * nt + 1]);
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j % a.slots]);  // this warp is past it
  }
  finish();
}

// The tensor map of a cache [B, T, Hkv, D] (element strides sb, st, sh, 1):
// boxes of `rows` rows of one head and box_cols columns, under the swizzle
// of their row's bytes (`swizzle`: 128 or 64) where the tensor cores read
// the slot, else none (0); HEADS: of a.box_n runs of a.box_w elements, all
// dh columns of a.box_heads KV heads: where a.box_w is dh, over the heads
// (stride sh), else over the [B, T, Hkv * D] view of a cache whose heads are
// contiguous, cut into runs of box_w (`run_box`).
template <typename E, int D, bool HEADS = false>
cudaError_t cache_map(CUtensorMap* map, const void* base, const Args& a,
                      long long sb, long long st, long long sh,
                      int swizzle) {
  const bool run = HEADS && a.box_w != a.dh;
  // innermost extent dh: TMA zero-fills columns dh .. D-1
  const cuuint64_t dims[4] = {
      (cuuint64_t)(HEADS ? a.box_w : a.dh),
      (cuuint64_t)(run ? (long long)a.Hkv * a.dh / a.box_w : a.Hkv),
      (cuuint64_t)a.T, (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {
      (cuuint64_t)(run ? a.box_w : sh) * sizeof(E),
      (cuuint64_t)st * sizeof(E), (cuuint64_t)sb * sizeof(E)};
  const cuuint32_t box[4] = {
      HEADS ? (cuuint32_t)a.box_w : (cuuint32_t)box_cols<E, D>(),
      HEADS ? (cuuint32_t)a.box_n : 1u, (cuuint32_t)a.rows, 1};
  return encode_tensor_map(
      map,
      sizeof(E) == 4                   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : sizeof(E) == 1                 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
      : std::is_same_v<E, __half> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, base, dims, strides, box,
      swizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename E, typename EQ, int D, bool EXACT, bool TMA,
          bool HEADS = false, int HX = 1>
cudaError_t launch(Args& a, int blocks, cudaStream_t stream) {
  int smem = 0;
  a.slots = ring_slots<E, D, HEADS, HX>(a.B, a.rows, &smem, a.box_heads,
                                        a.dh);
  if (a.slots == 0) return cudaErrorInvalidValue;
  static SmemAllowance allowance;
  auto kernel = paged_attention_kernel<E, EQ, D, EXACT, TMA, HEADS, HX>;
  cudaError_t err = allow_smem(allowance, kernel, MAX_SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap kmap{}, vmap{};        // the element copy goes without
  if (TMA && !a.copy) {
    constexpr int swizzle = !HEADS && tensor_core_qk<E, EQ, D>()
                                ? box_cols<E, D>() * (int)sizeof(E)
                                : 0;
    if ((err = cache_map<E, D, HEADS>(&kmap, a.k, a, a.k_sb, a.k_st, a.k_sh,
                                      swizzle)) != cudaSuccess)
      return err;
    if ((err = cache_map<E, D, HEADS>(&vmap, a.v, a, a.v_sb, a.v_st, a.v_sh,
                                      swizzle)) != cudaSuccess)
      return err;
  }
  kernel<<<blocks, NT + 32, smem, stream>>>(a, kmap, vmap);
  return cudaGetLastError();
}

// The wide body (the note at the top): E the caches' type, EQ q's and
// out's; TMA where the rows are whole 16-byte pieces, else the producer
// warp copies them by element. Column chunk blockIdx.y: V's and out's
// pieces [8 y, 8 y + npb) of the head's a.npk (one chunk up to 2048
// columns), Q K^T over all a.npk of K's.
template <typename E, typename EQ, bool TMA>
__global__ void __launch_bounds__(NT + 32)
paged_wide_kernel(const Args a, const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap) {
  constexpr int ITEM = sizeof(E);
  constexpr int IN = box_cols<E, WIDE_DC>();  // columns of a box
  constexpr int NBX = WIDE_DC / IN;           // boxes a piece
  constexpr int EPL = WIDE_DC / 32;           // a lane's columns of a piece
  constexpr int HS = GC;                      // query heads a segment
  extern __shared__ __align__(128) unsigned char wsmem[];
  const int npw = wide_npw(a.npk);            // pieces a warp takes
  const WideSmem L = wide_smem<E>(a.B, a.rows, a.slots, npw);
  uint64_t* full = reinterpret_cast<uint64_t*>(wsmem);  // a slot loaded
  uint64_t* empty = full + a.slots;                      // a slot released
  long long* P = reinterpret_cast<long long*>(wsmem + L.P);
  float* xch = reinterpret_cast<float*>(wsmem + L.xch);
  float* accs = reinterpret_cast<float*>(wsmem + L.acc);
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wsmem + L.ring) + 127) & ~(uintptr_t)127);
  const size_t box_bytes = L.box, slot_bytes = L.slot;
  // element (r, d) of a slot's piece: box d / IN, row r, column d % IN
  auto at = [&](const unsigned char* slot, int r, int d) {
    return reinterpret_cast<const E*>(slot + (d / IN) * box_bytes +
                                      (r * IN + d % IN) * ITEM);
  };
  auto put = [&](long long i, float x) {
    if constexpr (QType<EQ>::runtime) store_typed(a.out, i, x, a.qt);
    else static_cast<EQ*>(a.out)[i] = from_float<EQ>(x);
  };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // a consumer warp's query head, and the parity of the pieces it takes
  const int hw = warp % GC, half = warp / GC;
  const bool tma = TMA && !a.copy;
  const int hg = a.Hkv * a.ngc;               // segments a sequence
  const int S = a.B * hg;
  const int Dh = a.dh;
  const int c0 = blockIdx.y * WIDE_PIECES * WIDE_DC;  // the chunk's columns
  const int npb = min(WIDE_PIECES, a.npk - blockIdx.y * WIDE_PIECES);
  const int DW = min(WIDE_PIECES, a.npk) * WIDE_DC;   // columns a partial
  const int STRIDE = HS * (DW + 2);
  float* const parts =
      a.part + (size_t)blockIdx.y * (gridDim.x + S) * STRIDE;
  const int ngroups = (gridDim.x + MERGE_GROUP - 1) / MERGE_GROUP;
  int* const tickets = a.tickets + (size_t)blockIdx.y * S * (1 + ngroups);
  int* const gtickets = tickets + S;

  block_start(a, full, empty, P, tma, &kmap, &vmap);
  auto heads = [&](int s, int& b, int& h, int& g0, int& gn) {
    group_of(a, hg, HS, s, b, h, g0, gn);
  };
  zero_empty(a, P, hg, Dh, heads, put);
  long long per, lo, hi;
  block_share(P, a.B, hg, per, lo, hi);
  if (lo >= hi) return;

  if (warp == NSET * GC) {
    // the producer: for each chunk of rows of the share, all its K pieces,
    // then the column chunk's V pieces, item it into slot it % slots as
    // soon as the 8 warps that read the slot's last piece have released it
    long long g = lo;
    int it = 0;
    while (g < hi) {
      int s, b, h, g0, gn;
      long long t, end;
      locate(P, a.B, hg, g, s, t, end);
      heads(s, b, h, g0, gn);
      const int n = (int)min((long long)a.rows, min(end, hi) - g);
      for (int x = 0; x < a.npk + npb; ++x, ++it) {
        const int slot = it % a.slots;
        if (it >= a.slots)
          mbar_wait(&empty[slot], (uint32_t)((it / a.slots - 1) & 1));
        const bool kv = x >= a.npk;          // a V piece (of the chunk's)
        const int col = kv ? c0 + (x - a.npk) * WIDE_DC : x * WIDE_DC;
        unsigned char* dst = ring + (size_t)slot * slot_bytes;
        if (tma) {
          if (lane == 0) {
            mbar_arrive_expect_tx(&full[slot],
                                  (uint32_t)(a.rows * WIDE_DC * ITEM));
#pragma unroll
            for (int bx = 0; bx < NBX; ++bx)
              tma_load_4d(dst + bx * box_bytes, kv ? &vmap : &kmap,
                          &full[slot], col + bx * IN, h, (int)t, b);
          }
        } else {      // by element, columns dh.. zero; each lane arrives
          const E* src = static_cast<const E*>(kv ? a.v : a.k) +
                         b * (kv ? a.v_sb : a.k_sb) +
                         t * (kv ? a.v_st : a.k_st) +
                         h * (kv ? a.v_sh : a.k_sh);
          const long long st = kv ? a.v_st : a.k_st;
          constexpr int UNROLL = 8;          // loads in flight a lane
          const int total = n * WIDE_DC;
          for (int i0 = lane; i0 < total; i0 += 32 * UNROLL) {
            E xv[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
              const int i = i0 + 32 * u;
              xv[u] = i < total ? col_or_zero(src + (i / WIDE_DC) * st,
                                              col + i % WIDE_DC, a.dh)
                                : zero<E>();
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
              const int i = i0 + 32 * u;
              if (i < total)
                *const_cast<E*>(at(dst, i / WIDE_DC, i % WIDE_DC)) = xv[u];
            }
          }
          mbar_arrive(&full[slot]);          // release: this lane's stores
        }
      }
      g += n;
    }
    return;
  }

  // the consumers: all 16 warps take every chunk; warp (hw, half) the K
  // and V pieces of parity `half` for query head hw, a lane EPL columns of
  // each piece and, for the softmax, one row of the chunk. A lane's
  // accumulators of its piece pp (the warp's pieces 0, 1, .. npw - 1) in
  // shared memory, in registers while P V runs over the piece
  const int d0 = lane * EPL;
  float m = NEG_INF, l = 0.f;
  auto acc_at = [&](int pp) {
    return accs + ((warp * npw + pp) * 32 + lane) * EPL;
  };
  int cur = -1, b = 0, h = 0, g0 = 0, gn = 0;

  // the block's share of segment `cur` is done: write it, or its partial
  // and merge (two levels, as the note at the top says)
  auto finish = [&]() {
    const bool live = hw < gn;
    long long first;
    int count;
    segment_blocks(P, b, hg, cur, per, first, count);
    if (count == 1) {                        // the block holds it alone
      if (live) {
        const long long o = out_index(a, b, h, g0, hw) + c0 + d0;
        const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
        for (int pp = 0; pp < WIDE_NPW; ++pp) {
          const int pc = NSET * pp + half;
          if (pc >= npb) break;
          float x[EPL];
          load_vec<float, EPL>(acc_at(pp), x);
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            if (c0 + pc * WIDE_DC + d0 + e < Dh)
              put(o + pc * WIDE_DC + e, x[e] * inv);
        }
      }
      return;
    }
    const long long base = first + cur;      // the segment's partials
    float* mine = parts + (base + blockIdx.x - first) * STRIDE;
    if (live) {
      if (half == 0 && lane == 0) {
        mine[hw] = m;
        mine[HS + hw] = l;
      }
#pragma unroll
      for (int pp = 0; pp < WIDE_NPW; ++pp) {
        const int pc = NSET * pp + half;
        if (pc < npb) {
          float x[EPL];
          load_vec<float, EPL>(acc_at(pp), x);
          st_vec<EPL>(mine + 2 * HS + hw * DW + pc * WIDE_DC + d0, x);
        }
      }
    }
    // merges partials m_lo + i m_st (i < m_n) into dst (a partial) or into
    // out: warp (hw, half) head hw's columns of its pieces, lane l the
    // weight of partials l, l + 32, .., MB partials' loads in flight at a
    // time; the sums wait in the warp's accumulators (its partial is
    // written) until every partial has been read, as dst may be one of them
    auto merge = [&](long long m_lo, int m_n, int m_st, float* dst) {
      constexpr int MB = 4;
      auto partial = [&](int i) {
        return parts + (m_lo + (long long)i * m_st) * STRIDE;
      };
      float mx = NEG_INF, ls = 0.f;
      if (live) {
        for (int i = lane; i < m_n; i += 32)
          mx = fmaxf(mx, __ldcg(partial(i) + hw));
        mx = warp_max(mx);
        auto weight = [&](int i) {
          return i < m_n ? expf(__ldcg(partial(i) + hw) - mx) : 0.f;
        };
        for (int i = lane; i < m_n; i += 32)
          ls = fmaf(__ldcg(partial(i) + HS + hw), weight(i), ls);
        ls = warp_sum(ls);
#pragma unroll
        for (int pp = 0; pp < WIDE_NPW; ++pp) {
          const int pc = NSET * pp + half;
          if (pc >= npb) break;
          const int col = 2 * HS + hw * DW + pc * WIDE_DC + d0;
          float as[EPL] = {}, w = 0.f;
          for (int k0 = 0; k0 < m_n; k0 += MB) {
            if (k0 % 32 == 0) w = weight(k0 + lane);
            float x[MB][EPL];
#pragma unroll
            for (int k = 0; k < MB; ++k) {
              if (k0 + k < m_n) {
                ldcg_vec<EPL>(partial(k0 + k) + col, x[k]);
              } else {
#pragma unroll
                for (int e = 0; e < EPL; ++e) x[k][e] = 0.f;
              }
            }
#pragma unroll
            for (int k = 0; k < MB; ++k) {
              const float wk = __shfl_sync(FULL, w, (k0 + k) & 31);
#pragma unroll
              for (int e = 0; e < EPL; ++e) as[e] = fmaf(x[k][e], wk, as[e]);
            }
          }
          st_vec<EPL>(acc_at(pp), as);
        }
      }
      consumers_sync();         // every partial read: dst may be one of them
      if (!live) return;
      const float inv = 1.f / fmaxf(ls, 1e-30f);
      if (dst && half == 0 && lane == 0) {
        dst[hw] = mx;
        dst[HS + hw] = ls;
      }
#pragma unroll
      for (int pp = 0; pp < WIDE_NPW; ++pp) {
        const int pc = NSET * pp + half;
        if (pc >= npb) continue;
        float as[EPL];
        load_vec<float, EPL>(acc_at(pp), as);
        if (dst) {
          st_vec<EPL>(dst + 2 * HS + hw * DW + pc * WIDE_DC + d0, as);
        } else {
          const long long o =
              out_index(a, b, h, g0, hw) + c0 + pc * WIDE_DC + d0;
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            if (c0 + pc * WIDE_DC + d0 + e < Dh) put(o + e, as[e] * inv);
        }
      }
    };
    merge_partials(true, count, first, base, cur, tickets, gtickets, ngroups,
                   parts, STRIDE, merge);
  };

  long long g = lo;
  int it = 0;                                // the chunk's first item
  for (int j = 0; g < hi; ++j) {
    int s;
    long long t, end;
    locate(P, a.B, hg, g, s, t, end);
    const int n = (int)min((long long)a.rows, min(end, hi) - g);
    if (s != cur) {                          // a new segment
      if (cur != -1) finish();
      cur = s;
      heads(s, b, h, g0, gn);
      m = NEG_INF;
      l = 0.f;
      const float zeros[EPL] = {};
      for (int pp = 0; pp < npw; ++pp) st_vec<EPL>(acc_at(pp), zeros);
    }
    g += n;
    const bool live = hw < gn;     // the warp's head is one of the group's
    const long long qh = q_index(a, b, h, g0, hw);
    // Q K^T over the warp's K pieces (of the whole head, whatever the
    // chunk), each as it lands (getfin): a lane's columns of a piece, every
    // row, then the transpose reduction (lane r: the piece's part of row r's
    // logit), summed over the pieces. (Summing the lanes' columns over the
    // pieces first kept 32 sums live across the waits: 300-480 bytes of
    // spills, Q K^T 0.61 of a warp at D2048.)
    float lgt = 0.f;
    for (int pc = half; pc < a.npk; pc += NSET) {
      const int i = it + pc, slot = i % a.slots;
      mbar_wait(&full[slot], (uint32_t)((i / a.slots) & 1));   // getfin
      if (live) {
        float qp[EPL];
        long long qi[EPL];
        bool ok[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          qi[e] = qh + pc * WIDE_DC + d0 + e;
          ok[e] = pc * WIDE_DC + d0 + e < Dh;
        }
        load_q<EQ, EPL>(a.q, qi, ok, a.qt, qp);
        const unsigned char* ks = ring + (size_t)slot * slot_bytes;
        float part[32];
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          float dot = 0.f;
          if (r < n) {
            float kv[EPL];
            load_row<E, EPL>(at(ks, r, d0), kv, a.e5m2);
#pragma unroll
            for (int e = 0; e < EPL; ++e) dot = fmaf(qp[e], kv[e], dot);
          }
          part[r] = dot;
        }
        transpose_sum<16>(part, lane);
        transpose_sum<8>(part, lane);
        transpose_sum<4>(part, lane);
        transpose_sum<2>(part, lane);
        transpose_sum<1>(part, lane);
        lgt += part[0];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);   // this warp is past it
    }
    // the two parities' parts of each logit, added through shared memory
    // (two buffers: a warp one chunk ahead writes the other)
    float* xb = xch + (j & 1) * (NSET * GC * 32);
    xb[(half * GC + hw) * 32 + lane] = lgt;
    consumers_sync();
    float p = 0.f, alpha = 1.f;
    if (live) {
      const float sc = lane < n ? (xb[hw * 32 + lane] +
                                   xb[(GC + hw) * 32 + lane]) * a.scale
                                : NEG_INF;
      const float m_new = fmaxf(m, warp_max(sc));
      alpha = expf(m - m_new);
      p = lane < n ? expf(sc - m_new) : 0.f;
      l = fmaf(l, alpha, warp_sum(p));
      m = m_new;
    }
    // P V over the warp's V pieces: a piece's accumulators rescaled by
    // alpha, p_r V[r] added over the rows, written back
#pragma unroll
    for (int pp = 0; pp < WIDE_NPW; ++pp) {
      const int pc = NSET * pp + half;
      if (pc >= npb) break;
      const int i = it + a.npk + pc, slot = i % a.slots;
      mbar_wait(&full[slot], (uint32_t)((i / a.slots) & 1));   // getfin
      if (live) {
        const unsigned char* vs = ring + (size_t)slot * slot_bytes;
        float x[EPL];
        load_vec<float, EPL>(acc_at(pp), x);
#pragma unroll
        for (int e = 0; e < EPL; ++e) x[e] *= alpha;
#pragma unroll 8
        for (int r = 0; r < n; ++r) {
          const float pr = __shfl_sync(FULL, p, r);
          float vv[EPL];
          load_row<E, EPL>(at(vs, r, d0), vv, a.e5m2);
#pragma unroll
          for (int e = 0; e < EPL; ++e) x[e] = fmaf(pr, vv[e], x[e]);
        }
        st_vec<EPL>(acc_at(pp), x);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);   // this warp is past it
    }
    it += a.npk + npb;
  }
  finish();
}

// The wide body's launch: its ring (`wide_ring_slots`), the caches' tensor
// maps where its rows are TMA's, a grid of `blocks` x the chunks of
// WIDE_PIECES pieces of a.npk (one up to 2048 columns).
template <typename E, typename EQ>
cudaError_t launch_wide(Args& a, int blocks, cudaStream_t stream, bool tma) {
  int smem = 0;
  a.slots = wide_ring_slots<E>(a.B, a.rows, wide_npw(a.npk), &smem);
  if (a.slots == 0) return cudaErrorInvalidValue;
  static SmemAllowance allowance_tma, allowance_copy;
  auto kernel = tma ? &paged_wide_kernel<E, EQ, true>
                    : &paged_wide_kernel<E, EQ, false>;
  cudaError_t err = allow_smem(tma ? allowance_tma : allowance_copy, kernel,
                               MAX_SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap kmap{}, vmap{};        // the element copy goes without
  if (tma) {
    if ((err = cache_map<E, WIDE_DC>(&kmap, a.k, a, a.k_sb, a.k_st, a.k_sh,
                                     0)) != cudaSuccess)
      return err;
    if ((err = cache_map<E, WIDE_DC>(&vmap, a.v, a, a.v_sb, a.v_st, a.v_sh,
                                     0)) != cudaSuccess)
      return err;
  }
  const dim3 grid(blocks, (a.npk + WIDE_PIECES - 1) / WIDE_PIECES);
  kernel<<<grid, NT + 32, smem, stream>>>(a, kmap, vmap);
  return cudaGetLastError();
}

// Dp of the note at the top (above 256, the WIDE_DC-column chunks that
// cover D); 0 for a head size the kernel does not take.
int padded(int D) {
  if (D > WIDE_DC) return (D + WIDE_DC - 1) / WIDE_DC * WIDE_DC;
  for (int p = 16; p <= WIDE_DC; p *= 2)
    if (D >= 1 && D <= p) return p;
  return 0;
}

bool fp8_type(int dtype) {
  return dtype == DTYPE_E4M3 || dtype == DTYPE_E5M2;
}

// Whether rows of D elements of `dtype` are a whole number of 16-byte
// pieces, which TMA loads (the note at the top).
bool tma_rows(int dtype, int D) {
  const int item = dtype == DTYPE_F32 ? 4 : fp8_type(dtype) ? 1 : 2;
  return D * item % 16 == 0;
}

bool float_type(int dtype) {
  return dtype == DTYPE_F32 || dtype == DTYPE_BF16 || dtype == DTYPE_F16 ||
         fp8_type(dtype);
}

// The launch at (Dp, D) for caches of type E and q of type EQ: the body for
// Dp, EXACT at D == Dp (q of the caches' type only), TMA where the rows are
// whole 16-byte pieces; the wide body above 256; the unpadded slots (HEADS)
// for rows of no whole 16-byte pieces, loaded by TMA runs or copied
// (a.copy), and for segments of a.heads KV heads where that is more than 1
// (`kv_run`); two query heads a warp where a.hx is 2 (`group_heads`).
template <typename E, typename EQ>
cudaError_t launch_typed(Args& a, int blocks, cudaStream_t s, int Dp, int D,
                         bool tma) {
  constexpr bool kSame = std::is_same_v<E, EQ>;
  if constexpr (kSame && sizeof(E) == 2) {
    if (Dp > WIDE_DC && Dp <= MMA_WIDE && tma) {   // the whole head a block
      a.npk = 1;
      return launch<E, EQ, MMA_WIDE, false, true>(a, blocks, s);
    }
  }
  if (Dp > WIDE_DC) {                      // the wide body
    a.npk = Dp / WIDE_DC;
    return launch_wide<E, EQ>(a, blocks, s, tma);
  }
  a.npk = 1;
  if (!tma) {
#define ELEM_CASE(DIM) \
  case DIM: return launch<E, EQ, DIM, false, true, true>(a, blocks, s)
    switch (Dp) {
      ELEM_CASE(16);
      ELEM_CASE(32);
      ELEM_CASE(64);
      ELEM_CASE(128);
      ELEM_CASE(256);
    }
#undef ELEM_CASE
    return cudaErrorInvalidValue;
  }
  if constexpr (kSame && sizeof(E) == 2) {
    if (a.heads > 1) {
#define HEADS_CASE(DIM)                                                    \
  case DIM:                                                                \
    return Dp == D ? launch<E, EQ, DIM, true, true, true>(a, blocks, s) \
                   : launch<E, EQ, DIM, false, true, true>(a, blocks, s)
      switch (Dp) {
        HEADS_CASE(64);
        HEADS_CASE(128);
        HEADS_CASE(256);
      }
#undef HEADS_CASE
      return cudaErrorInvalidValue;
    }
    if (a.hx == 2) {                         // (Dp 256: `group_heads`)
      if (Dp != 256) return cudaErrorInvalidValue;
      if (Dp == D)
        return launch<E, EQ, 256, true, true, false, 2>(a, blocks, s);
      return launch<E, EQ, 256, false, true, false, 2>(a, blocks, s);
    }
  }
#define PAGED_CASE(DIM)                                                  \
  case DIM:                                                              \
    if constexpr (kSame)                                                 \
      if (Dp == D) return launch<E, EQ, DIM, true, true>(a, blocks, s); \
    return launch<E, EQ, DIM, false, true>(a, blocks, s)
  switch (Dp) {
    PAGED_CASE(16);
    PAGED_CASE(32);
    PAGED_CASE(64);
    PAGED_CASE(128);
    PAGED_CASE(256);
  }
#undef PAGED_CASE
  return cudaErrorInvalidValue;
}

// The tensor-core launch of fp8 caches (`products`): the TMA body for Dp
// of 64 to 256, q and out of type a.qt, products in EQ's M; two query heads
// a warp where a.hx is 2.
template <typename E, typename EQ>
cudaError_t launch_mma(Args& a, int blocks, cudaStream_t s, int Dp) {
  a.npk = 1;
  if (a.hx == 2) {
    if (Dp != 256) return cudaErrorInvalidValue;
    return launch<E, EQ, 256, false, true, false, 2>(a, blocks, s);
  }
  switch (Dp) {
    case 64: return launch<E, EQ, 64, false, true>(a, blocks, s);
    case 128: return launch<E, EQ, 128, false, true>(a, blocks, s);
    case 256: return launch<E, EQ, 256, false, true>(a, blocks, s);
  }
  return cudaErrorInvalidValue;
}

// KV heads a segment (the note at the top): more than one where a group
// of G query heads leaves warps of a set idle (G < GC, G dividing GC, Dp at
// most 256): for rows of no whole 16-byte pieces in every type under any q,
// and for 16-bit rows of whole pieces under a q of their type on the TMA
// ring at Dp 64 to 256, at G = 1, or at G of 2 and 4 where D < Dp: GC / G,
// halved until it divides Hkv. Otherwise 1.
int kv_run(int dtype, int q_dtype, int D, int G, int Hkv) {
  const int Dp = padded(D);
  if (!float_type(dtype) || Dp == 0 || Dp > WIDE_DC || G < 1 || G >= GC ||
      GC % G != 0 || Hkv < 1)
    return 1;
  if (tma_rows(dtype, D) &&
      ((dtype != DTYPE_BF16 && dtype != DTYPE_F16) || q_dtype != dtype ||
       Dp < 64 || (G > 1 && D == Dp)))
    return 1;
  int r = GC / G;
  while (Hkv % r != 0) r /= 2;
  return r;
}

int item_of(int dtype) {
  return dtype == DTYPE_F32 ? 4 : fp8_type(dtype) ? 1 : 2;
}

// A TMA box's innermost extent for a run of n elements of `item` bytes
// whose bytes are whole 16-byte pieces: the widest w of at most 256
// elements, a whole number of pieces, that divides n, with n / w boxes of
// it across (at most 256); 0 where that is more.
int box_width(int n, int item) {
  const int u = 16 / item, k = n / u;
  for (int d = 256 / u; d >= 1; --d)
    if (k % d == 0) return k / d <= 256 ? u * d : 0;
  return 0;
}

// KV heads a TMA box of a launch's unpadded slots holds where a row of D
// elements is no whole number of 16-byte pieces but a run of the heads of a
// token is (the note at the top): the smallest multiple of `heads` (`kv_run`)
// that divides Hkv and whose row of D columns a head is whole 16-byte pieces,
// where both caches' heads are contiguous (sh == D), their other strides (st,
// sb: cs = {k_sb, k_st, k_sh, v_sb, v_st, v_sh} in elements) multiples of
// 16 bytes, both starts 16-byte aligned (`aligned`), the run cut into TMA
// boxes (`box_width`) and two of its rows within HEADS_SLOT_BYTES; 0 where
// not (the producer warp copies the rows).
int run_box(int dtype, int D, int Hkv, int heads, const long long* cs,
            bool aligned) {
  const int Dp = padded(D), item = item_of(dtype);
  if (!float_type(dtype) || Dp == 0 || Dp > WIDE_DC || tma_rows(dtype, D) ||
      !aligned || heads < 1)
    return 0;
  for (int i = 0; i < 2; ++i)
    if (cs[3 * i + 2] != D || cs[3 * i + 1] * item % 16 != 0 ||
        cs[3 * i] * item % 16 != 0)
      return 0;
  for (int rb = heads; rb <= Hkv; rb += heads) {
    if (Hkv % rb != 0 || rb * D * item % 16 != 0) continue;
    return box_width(rb * D, item) > 0 &&
                   2 * rb * D * item <= HEADS_SLOT_BYTES
               ? rb
               : 0;
  }
  return 0;
}

// The bytes of one load of the element copy: the widest of 16, 8, 4 and 2
// (at least an element) that a head's row, both caches' strides (cs as in
// `run_box`) and starts (addr: their bitwise or) are multiples of.
int copy_width(int dtype, int D, const long long* cs, unsigned long long addr) {
  const int item = item_of(dtype);
  for (int w = 16; w > item; w /= 2) {
    bool ok = D * item % w == 0 && addr % w == 0;
    for (int i = 0; i < 6; ++i) ok = ok && cs[i] * item % w == 0;
    if (ok) return w;
  }
  return item;
}

// Where a launch's products run (dtype the caches', q_dtype q's; G query
// heads a KV head, Hkv KV heads): 1 on the tensor cores, 0 on fp32 FMAs.
// The TMA body with 16-bit caches and q of their type at Dp 64 to 256 and
// at 512 (the whole head a block, 256 < D <= 512; segments of one KV head:
// `kv_run` 1), or fp8 caches and a q of 16 bits or fp8 at Dp 64 to 256
// (read in its own type; an fp32 q stays on FMAs); not the wide body.
int products(int dtype, int q_dtype, int D, int G, int Hkv) {
  const int Dp = padded(D);
  if (!float_type(dtype) || !tma_rows(dtype, D) || Dp < 64) return 0;
  if (dtype == DTYPE_BF16 || dtype == DTYPE_F16)
    return q_dtype == dtype && Dp <= MMA_WIDE &&
           kv_run(dtype, q_dtype, D, G, Hkv) == 1;
  if (Dp > WIDE_DC) return 0;
  if (fp8_type(dtype))
    return q_dtype == DTYPE_BF16 || q_dtype == DTYPE_F16 ||
           fp8_type(q_dtype);
  return 0;
}

// The wide body's chunks of WIDE_PIECES pieces of WIDE_DC columns, each its
// own blocks over every valid row (the grid's second dimension): one up to
// 2048 columns, so that a block takes the whole head and K is read once;
// ceil(Dp / 2048) above, where the products run on FMAs; else 1.
int wide_chunks(int dtype, int q_dtype, int D, int G, int Hkv) {
  const int pieces = padded(D) / WIDE_DC;
  return padded(D) > WIDE_DC && !products(dtype, q_dtype, D, G, Hkv)
             ? (pieces + WIDE_PIECES - 1) / WIDE_PIECES
             : 1;
}

// Query heads a segment of one KV head serves: 2 GC where a KV head has more
// than GC of them and the products run on the tensor cores (`products`) at
// Dp 256, each warp of a set two (HX 2; the note at the top); GC elsewhere.
int group_heads(int dtype, int q_dtype, int D, int G, int Hkv) {
  return G > GC && padded(D) == WIDE_DC && products(dtype, q_dtype, D, G, Hkv)
             ? 2 * GC
             : GC;
}

// The ring of a launch for caches of type E (EQ does not enter), slot rows
// of `heads` KV heads (unpadded where `unpadded`: rows of no whole 16-byte
// pieces, or more than one head), `hx` query heads a warp; `whole`: the
// tensor-core body above WIDE_DC (`products`), else the wide body's ring.
template <typename E>
int ring_for(int B, int D, int rows, int heads, int hx, bool unpadded,
             bool whole, int* smem) {
  const int Dp = padded(D);
  if (Dp > WIDE_DC && whole) return ring_slots<E, MMA_WIDE>(B, rows, smem);
  if (hx == 2)
    return Dp == 256 ? ring_slots<E, 256, false, 2>(B, rows, smem)
                     : -1;
  if (unpadded) {
    switch (Dp) {
      case 16:
        return ring_slots<E, 16, true>(B, rows, smem, heads, D);
      case 32:
        return ring_slots<E, 32, true>(B, rows, smem, heads, D);
      case 64:
        return ring_slots<E, 64, true>(B, rows, smem, heads, D);
      case 128:
        return ring_slots<E, 128, true>(B, rows, smem, heads, D);
      case 256:
        return ring_slots<E, 256, true>(B, rows, smem, heads, D);
    }
    return -1;
  }
  switch (Dp) {
    case 0: return -1;
    case 16: return ring_slots<E, 16>(B, rows, smem);
    case 32: return ring_slots<E, 32>(B, rows, smem);
    case 64: return ring_slots<E, 64>(B, rows, smem);
    case 128: return ring_slots<E, 128>(B, rows, smem);
    case 256: return ring_slots<E, 256>(B, rows, smem);
  }
  return wide_ring_slots<E>(B, rows, wide_npw(Dp / WIDE_DC), smem);
}

}  // namespace

// The body a launch at (dtype, D) runs, dtype the caches' type: 0 the TMA
// ring, 1 the body of rows of no whole 16-byte pieces (unpadded slots, by
// TMA runs of heads or copied: `paged_attention_run`), -1 none (the
// wrapper's `body_for` states the same rule).
extern "C" int paged_attention_body(int dtype, int D) {
  if (!float_type(dtype) || padded(D) == 0) return -1;
  return tma_rows(dtype, D) ? 0 : 1;
}

// The KV heads of a TMA box of a launch at (dtype, q_dtype, D, Hq, Hkv)
// over caches of strides cs = {k_sb, k_st, k_sh, v_sb, v_st, v_sh}
// (elements) whose starts are 16-byte aligned (`aligned`), where their rows
// are no whole 16-byte pieces: `run_box`, 0 where the producer warp copies
// the rows (the wrapper's `run_heads` states the same rule).
extern "C" int paged_attention_run(int dtype, int q_dtype, int D, int Hq,
                                   int Hkv, const long long* cs,
                                   int aligned) {
  return run_box(dtype, D, Hkv,
                 kv_run(dtype, q_dtype, D, Hkv > 0 ? Hq / Hkv : 0, Hkv), cs,
                 aligned != 0);
}

// Where the products of a launch at (dtype, q_dtype, D, Hq, Hkv) run: 1
// mma.sync, 0 fp32 FMAs (the wrapper's `products_on` states the same rule).
extern "C" int paged_attention_products(int dtype, int q_dtype, int D,
                                        int Hq, int Hkv) {
  return products(dtype, q_dtype, D, Hkv > 0 ? Hq / Hkv : 0, Hkv);
}

// The KV heads a segment of a launch at (dtype, q_dtype, D, Hq, Hkv) takes
// (`kv_run`; the wrapper's `kv_heads` states the same rule).
extern "C" int paged_attention_heads(int dtype, int q_dtype, int D, int Hq,
                                     int Hkv) {
  return kv_run(dtype, q_dtype, D, Hkv > 0 ? Hq / Hkv : 0, Hkv);
}

// The chunks of up to 2048 output columns of a launch at (dtype, q_dtype,
// D, Hq, Hkv), each its own blocks (`wide_chunks`: 1 up to 2048 columns;
// the wrapper's plan states the same rule: `paged_plan`'s chunks).
extern "C" int paged_attention_chunks(int dtype, int q_dtype, int D, int Hq,
                                      int Hkv) {
  return wide_chunks(dtype, q_dtype, D, Hkv > 0 ? Hq / Hkv : 0, Hkv);
}

// The query heads a segment of one KV head serves in a launch at (dtype,
// q_dtype, D, Hq, Hkv) (`group_heads`; the wrapper's `query_heads` states
// the same rule): ngc = ceil(Hq / Hkv / it).
extern "C" int paged_attention_group(int dtype, int q_dtype, int D, int Hq,
                                     int Hkv) {
  return group_heads(dtype, q_dtype, D, Hkv > 0 ? Hq / Hkv : 0, Hkv);
}

// q [B, Hq, D] of type q_dtype (strides q_sb, q_sh, 1; at D of 16 .. 256 in
// powers of 2, q of the caches' type, starts and strides in multiples of
// max(D / 32, 1) elements), k/v [B, T, Hkv, D] of type dtype (strides sb,
// st, sh, 1; for the TMA body a 16-byte aligned start and strides in
// multiples of 16 bytes, for the element body anything), lengths [B] int32,
// out [B, Hq, D] of type q_dtype (strides o_sb, o_sh, 1); D >= 1; q_dtype
// is dtype, or beside 16-bit and fp8 caches any of f32, bf16, f16, e4m3fn,
// e5m2 (read and written in its own type; `products` says where the
// products run; the wrapper widens any other q to fp32). part: chunks x
// (blocks + segments) x HS x (min(Dp, 2048) + 2) floats, HS the query
// heads a segment serves (`paged_attention_group`); tickets: chunks x
// segments x (1 + ceil(blocks / 8)) ints, zero; chunks:
// `paged_attention_chunks` (1 up to 2048 columns). blocks (a chunk), rows,
// ngc (ceil(Hq / Hkv / HS), or the launch
// refuses it): `paged_plan` of paged_attention.py; the launch sizes the
// ring itself (`paged_attention_ring`). strides: {q_sb, q_sh, k_sb,
// k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_sh} in elements. The scale is
// 1 / sqrt(D). Returns 0 or a cudaError_t (invalid value where no ring
// fits); -1 for a head size or type it does not take.
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* part, void* tickets, int B, int Hq, int Hkv, int T,
    int D, int blocks, int rows, int ngc, const long long* st, int dtype,
    int q_dtype, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.part = static_cast<float*>(part);
  a.tickets = static_cast<int*>(tickets);
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.T = T;
  a.G = Hq / Hkv;
  a.ngc = ngc;
  a.rows = rows;
  a.dh = D;
  a.e5m2 = dtype == DTYPE_E5M2;
  a.qt = q_dtype;
  a.heads = kv_run(dtype, q_dtype, D, a.G, Hkv);
  const int hs = group_heads(dtype, q_dtype, D, a.G, Hkv);
  a.hx = hs / GC;
  if (ngc != (a.G + hs - 1) / hs) return (int)cudaErrorInvalidValue;
  a.q_sb = st[0];
  a.q_sh = st[1];
  a.k_sb = st[2];
  a.k_st = st[3];
  a.k_sh = st[4];
  a.v_sb = st[5];
  a.v_st = st[6];
  a.v_sh = st[7];
  a.o_sb = st[8];
  a.o_sh = st[9];
  const int Dp = padded(D);
  if (Dp == 0 || paged_attention_body(dtype, D) < 0) return -1;
  a.scale = static_cast<float>(1.0 / sqrt((double)D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tma = tma_rows(dtype, D);
  // the unpadded slots: a TMA box of a run of heads, or the producer warp's
  // copy; where one head's row is whole pieces, a box of `heads` heads
  const long long cs[6] = {a.k_sb, a.k_st, a.k_sh, a.v_sb, a.v_st, a.v_sh};
  const unsigned long long addr = (unsigned long long)(uintptr_t)k |
                                  (unsigned long long)(uintptr_t)v;
  const int rb = tma ? 0 : run_box(dtype, D, Hkv, a.heads, cs, addr % 16 == 0);
  a.copy = !tma && rb == 0;
  a.box_heads = rb > 0 ? rb : a.heads;
  a.box_w = rb > 0 ? box_width(rb * D, item_of(dtype)) : D;
  a.box_n = rb > 0 ? rb * D / a.box_w : a.heads;
  a.width = a.copy ? copy_width(dtype, D, cs, addr) : 0;
  if (q_dtype == dtype && !fp8_type(dtype)) {
    if (dtype == DTYPE_F32)
      return (int)launch_typed<float, float>(a, blocks, s, Dp, D, tma);
    if (dtype == DTYPE_BF16)
      return (int)launch_typed<__nv_bfloat16, __nv_bfloat16>(a, blocks, s,
                                                             Dp, D, tma);
    return (int)launch_typed<__half, __half>(a, blocks, s, Dp, D, tma);
  }
  // q of another float type than the caches': read and out written in
  // q's own type (q_as), the products on FMAs but for fp8 caches (`products`)
  if (!float_type(q_dtype) || dtype == DTYPE_F32) return -1;
  if (fp8_type(dtype) && products(dtype, q_dtype, D, a.G, Hkv)) {
    if (q_dtype == DTYPE_BF16)
      return (int)launch_mma<fp8_any, q_as<__nv_bfloat16>>(a, blocks, s, Dp);
    return (int)launch_mma<fp8_any, q_as<__half>>(a, blocks, s, Dp);
  }
  if (fp8_type(dtype))
    return (int)launch_typed<fp8_any, q_as<float>>(a, blocks, s, Dp, D, tma);
  if (dtype == DTYPE_BF16)
    return (int)launch_typed<__nv_bfloat16, q_as<float>>(a, blocks, s, Dp, D,
                                                         tma);
  return (int)launch_typed<__half, q_as<float>>(a, blocks, s, Dp, D, tma);
}

// The ring a block of the launch takes for B sequences, head size D (any
// D >= 1: the ring is Dp's, or the wide body's; q_dtype q's type as the
// kernel reads it, which decides between them above 256), `rows` rows an
// aload,
// slot rows of `heads` KV heads (those of a TMA box, `paged_attention_run`,
// where it is not 0, else of a segment, `paged_attention_heads`) and `group`
// query heads a segment of one (`paged_attention_group`): its slots (0 where none fits, -1 for a head
// size or type the kernel does not take) and, in *smem, its shared-memory
// bytes.
extern "C" int paged_attention_ring(int B, int D, int rows, int dtype,
                                    int q_dtype, int heads, int group,
                                    int* smem) {
  const int hx = group / GC;
  if ((hx != 1 && hx != 2) || (hx == 2 && (heads > 1 || dtype == DTYPE_F32)))
    return -1;
  if (!float_type(dtype) || padded(D) == 0) return -1;
  const bool unpadded =
      padded(D) <= WIDE_DC && (heads > 1 || !tma_rows(dtype, D));
  const bool whole = products(dtype, q_dtype, D, GC, 1) != 0;
  if (dtype == DTYPE_F32)
    return ring_for<float>(B, D, rows, heads, 1, unpadded, whole, smem);
  if (dtype == DTYPE_BF16)
    return ring_for<__nv_bfloat16>(B, D, rows, heads, hx, unpadded, whole,
                                   smem);
  if (dtype == DTYPE_F16)
    return ring_for<__half>(B, D, rows, heads, hx, unpadded, whole, smem);
  return ring_for<fp8_any>(B, D, rows, heads, hx, unpadded, whole, smem);
}
