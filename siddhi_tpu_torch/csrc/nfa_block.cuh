// K2 nfa_block: the sequential batched NFA over one (T, P) event block --
// the kernel template, shared by nfa_block.cu (1-4 slots a thread, A up
// to 128), nfa_block_wide.cu (8 or 16 slots a thread, A up to 512), their
// EXT twins nfa_block_ext.cu and nfa_block_wide_ext.cu, chunk mode's
// nfa_block_chunk.cu and nfa_block_chunk_ext.cu, and the float64 twin of
// each (`_f64`, @app:devicePrecision('f64')): twelve sources, so nvcc
// builds the instantiations in parallel.
//
// Replaces the jitted _block_impl of siddhi_tpu/core/nfa_device.py (:1486,
// :1560): lax.scan over T of _step (:726) with _alloc_head (:1328) and the
// E-lane drain _drain_done (:1428), then ceil(A/E) drain rounds (:1581),
// and the earliest live deadline (:1649).  The whole pattern algebra of
// the JAX step, init slots, slot forking and absent logical sides included.
// One warp per partition lane, one thread per slot (thread `lane` owns
// slots lane, lane+32, ... when A > 32).  Slot stations, count flags
// (cnt_on, narm: a bit per count position) and logical fill bits (two per
// logical position) live in registers; capture, counter and deadline rows
// in shared memory ([K][A] per warp).  Every step of _step but the drain
// and the head allocation is per slot, so each thread runs the JAX step's
// statements in their order on its own slots (kernels/nfa_block.py
// nfa_block_plain is the vector form of the same step):
//   0. the node matches the slot can use (its station's; with counts or
//      deadlines also every later node, and the collecting counts'): stream, pre-mask
//      bit, capture-dependent conjuncts through the VM on the captures as
//      they were before the event; a slot neither stationed nor
//      collecting skips the step;
//   1. absent deadlines at or before the event's timestamp fire when
//      deadlines may fire on this cell (dl_fire: timer ticks, and events
//      under playback): the slot advances (a chain of absent positions can
//      cascade) or, at the last position, completes with the deadline as
//      its timestamp; lazy, strict `within` expiry; the slot dies on
//      expiry or a forbidden arrival at an absent station;
//   2. count collection (station-independent), with a count's min
//      crossing arming its successor and the optional counts after it;
//      an adjacent count's entry consumes its predecessor's arm;
//   3. the stations: a logical pair gathers its fill bits (`or` completes
//      on either side, `and` on both), a stream position matches when
//      stationed there or through an armed predecessor count (walking back
//      over optional counts); an advance lands past optional counts;
//   4. death, completion (parked, or emitted in place while a final count
//      still collects), entries into positions (counters, fill bits,
//      deadlines, presence rows cleared), sequence strictness.
// Each slot width has three instantiations, chosen at launch: EXT (an
// init slot, an `every` below the head or an absent logical side) runs
// ext_step below; ALG (a count or logical position in the chain) runs
// steps 0-4 as above; otherwise chain_step runs the same step on stream
// and absent positions alone, matching only the station's node after the
// deadlines fire, with no count or fill-bit state (fewer registers, fewer
// node matches).
// The wide instantiations (8 or 16 slots a thread) keep the per-slot step
// and the head allocation rolled: unrolled 16 times the step takes nvcc
// minutes to compile, and slot growth past 128 slots is rare.
// A capture write that JAX defers to the end of the step is applied at
// once unless the slot dies in the step (death is known after 1): reads of
// captures happen in 0, and the only write whose value another write of
// the step would read -- a count's collection and its adjacent-count entry
// in one event -- is left to the entry, which overwrites every row the
// collection writes (nfa_block_plain does the same).  Then, per warp:
//   5. the drain: parked slots and in-place emissions ranked by slot index
//      (ballot + popc), the first E emit (parked ones free), in-place
//      emissions beyond E counted as lost (of_lanes: the plan doubles E);
//   6. the head: the lowest free slot (ballot + ffs) takes a new partial
//      match -- a stream head advances, a count head counts occurrence 1,
//      a logical head fills a side -- or the lane counts a dropped head.
// Matches append to the (rows, M) output through one atomicAdd per warp
// per drain; rows past M are counted but not written (the plan retries
// with a bigger M from the untouched input state).  Fused multi-query
// lanes (bcast) read the broadcast (T, 1) event grids at row t, their
// (T, P) pre-masks at (t, lane), `qparam` operands at the warp's lane, and
// emit the lane as the match's __qid__.  Chunk lanes (the `chunk`
// family; JAX: _expand_flat, nfa_device.py:1529, and the dedup at
// :1598-1604) read one flat (F,) buffer of a flush: lane `part` reads
// event part*cs + t (clipped to F - 1; valid while below nev, pre-mask
// bits at the same flat index), arms heads only for t < cs (a halo event
// extends pending matches but never starts one), runs from fresh state,
// and writes no completion whose seq is at or before prev_seq (the
// previous flush's last: a replay), so meta[0] counts what the JAX
// block's compaction counts.  Per-position, per-node and
// capture-write tables, column pointers and programs come in a device
// table; each block stages the programs in shared memory ahead of the
// warps' rows.
//
// What bounds K2 on the H100: not bytes (a block moves a few MB, microseconds
// at 3.35 TB/s) but the latency of the T-step chain each warp walks alone.
// Every step used to load its event -- ts, seq, valid, tick, stream code,
// one pre-mask word per node tested, the columns its programs and capture
// writes read -- from device memory, each load behind the branch before
// it, with nothing else of the warp in flight.  The event stage takes
// them off the chain: each warp keeps a ring of NST = 2 tiles of TT = 64
// steps in shared memory ahead of its slot rows.  At the start of tile k
// (the hand-over) a warp waits for tile k's copies (cp.async.wait_group
// 0, __syncwarp), issues tile k + 1's into the slot tile k - 1 held --
// lane i copies steps t0 + i and t0 + i + 32 with cp.async (4- and 8-byte
// copies, one commit group a tile), so a tile's copies have a whole tile
// of steps to land -- and turns its tile's raw words into what a step
// reads: one node word (bit gi = node gi's pre-mask bit, 1 where the node
// has none), the valid and tick flags, 0/1 for a BOOL column.  A step then
// reads only shared memory (ts, seq, stream code, flags, node word, and
// columns at their own width: 8-byte LONG/DOUBLE columns first, so they
// stay aligned, then 4-byte ones, BOOL as a 4-byte 0/1).  A tile holds
// stage_step = 24 + 8 n8 + 4 n4 + 4 n_nodes bytes a step (kernels/
// nfa_block.py `_stage_layout`); a warp's ring NST * TT * stage_step bytes
// (C4 `seq`: 40 bytes a step, 5 KB).  TT = 32 measured 0.5-2% slower on
// every K2 block chip_smoke times, so the ring has one size; a launch
// whose rows and ring do not fit the block's 227 KB fails.  Fused lanes
// (bcast) read one broadcast row a step for every warp: the block keeps
// that ring once (after the stage header), its live threads copy each
// tile's broadcast fields and columns between them and meet (barrier 1
// over the live warps) at every hand-over, after their own wait and
// before the next tile overwrites the slot all warps have left; each
// warp's own ring then holds its pre-mask words, node words, flags and
// BOOL columns only, since the pre-mask bits differ lane by lane.  Chunk
// lanes keep cp.async as well: their own-chunks start at any flat index
// and clip at F - 1, which the 16-byte spans of a bulk copy do not fit,
// and the fill is off the chain either way.  Which flat index a step
// reads is computed as before (stage_index); the step's statements,
// their order and the drain are unchanged.  Measured on an H100
// (scripts/k2_phases.py): the hand-over costs 1-2% of a heavy step and no
// step waits for a tile; the stage saved the one L2 round trip a step of
// a (T, P) grid's strided reads (5-9%), while chunk lanes and broadcast
// rows had hit L1 before.  A step is now bound by its own dependent work:
// the VM's interpretation and the per-position and per-node table loads
// (55-78% of its cycles), the head (9-27%) and the drain's atomicAdd
// (8-18%).
#pragma once
#include "expr_vm.cuh"

// The float capture and output rows' type, capf_t: float, or double in
// the `_f64` sources (the JAX package's caps_f at fdt, nfa_device.py:
// 604-605, and its separate float pack, :1655-1680), which define NFA_F64
// before including this header and get a namespace of their own, so that
// no kernel name is shared with a float32 library.  A FLOAT capture then
// sits widened in a double row; its programs read it as a double load
// cast back to float (core/nfa_device.py).  A per-source type and not a
// template parameter: the float32 sources compile the code they compiled
// before (as a template parameter FT, the float32 chain instantiation
// took 9% longer at config 5's block on an H100: same registers, other
// scheduling).
#ifdef NFA_F64
typedef double capf_t;
#define CAP_VT VT_F64
#define CAP_WORDS 2               // 4-byte words of one float row entry
#define VM_CAP vm_d
#define CAP_VAL(v) (v).d
namespace nfa_f64 {
#else
typedef float capf_t;
#define CAP_VT VT_F32
#define CAP_WORDS 1
#define VM_CAP vm_f
#define CAP_VAL(v) (v).f
#endif

#define NO_FIRST (1 << 30)
#define NO_DEADLINE 0x7fffffff
#define FULL 0xffffffffu

enum PosKind { K_STREAM = 0, K_ABSENT = 1, K_COUNT = 2, K_LOGICAL = 3 };
enum WriteMode { W_SRC = 0, W_ONE = 1, W_PREV = 2, W_IDX = 3, W_PRES_GE = 4 };

struct NfaParams {  // layout mirrored by kernels/nfa_block.py _Params
  int T, P, A, S, E, is_seq, every_head, multi, Kf, Ki, Kl, Ka, Kc, Klog, C, M;
  int ts_slot, wpb, bcast, playback, emit_qid, comp_ts_row, comp_seq_row, n_words;
  int n_consts, stage, prog_bytes, parked, all_pz_off, all_pz_len;
  int ext, needs_init, init_on_tick, has_anchor, anchor, init_land;
  int chunk, cs, nflat, nev, prev_seq;  // chunk lanes (flat events, halo reads)
  int tt, stage_step, stage_pre, n_nodes, warp_words;  // the event stage (tt: out)
  const int* ts;
  const int* seq;
  const unsigned char* valid;        // (T, G); chunk lanes derive it
  const unsigned char* tick;
  const int* scode;
  const long long* qparams;
  const void* const* ev;
  const int* ev_vt;
  const int* pos_kind;
  const int* pos_node;      // first node of the position
  const int* pos_within;
  const int* pos_dl_row;    // deadline row of an absent position, -1 none
  const int* pos_waiting;
  const int* pos_min;
  const int* pos_max;
  const int* pos_cnt;       // counter row of a count position
  const int* pos_log;       // fill-bit row of a logical position
  const int* pos_or;
  const int* pos_land;      // station after the position (past min-0 counts)
  const int* pos_pz_off;    // presence rows cleared on entering it
  const int* pos_pz_len;
  const int* node_scode;
  const unsigned* const* node_pre;
  const int* node_prog_off;
  const int* node_prog_len;
  const int* node_cw_off;   // capture writes of a stream capture
  const int* node_cw_len;
  const int* node_cc_off;   // capture writes of a count collection
  const int* node_cc_len;
  const int* node_pres;     // the node's presence row, -1 none
  const int* w_group;       // 0 f, 1 i, 2 l
  const int* w_row;
  const int* w_mode;
  const int* w_src;         // grid column
  const int* w_arg;         // W_PREV source row, W_IDX / W_PRES_GE count
  const int* pz_rows;
  const int* occ_in;
  const int* first_in;
  const int* hseq_in;
  const int* cnt_in;
  const unsigned char* con_in;
  const unsigned char* narm_in;
  const int* fl_in;
  const capf_t* capf_in;
  const int* capi_in;
  const long long* capl_in;
  const int* dl_in;
  const unsigned char* armed_in;
  const int* ofs_in;
  const int* ofl_in;
  const unsigned char* init_in;
  int* occ_out;
  int* first_out;
  int* hseq_out;
  int* cnt_out;
  unsigned char* con_out;
  unsigned char* narm_out;
  int* fl_out;
  capf_t* capf_out;
  int* capi_out;
  long long* capl_out;
  int* dl_out;
  unsigned char* armed_out;
  int* ofs_out;
  int* ofl_out;
  unsigned char* init_out;
  int* out_i;
  capf_t* out_f;
  long long* out_l;
  int* meta;
  const long long* consts;
  const int* words;
  const int* pos_sticky;    // `every` position (a standing arm that forks)
  const int* node_dl;       // deadline row of an absent node, -1 none
  const int* node_wait;     // its waiting time
  const int* node_absent;
  const int* ev_soff;       // a column's byte offset in a step of the stage
};

struct Caps {  // one warp's capture, deadline and counter rows, [K][A]
  capf_t* f;
  int* i;
  long long* l;
  int* d;
  int* c;
};

// ---- where a warp's cycles go (scripts/k2_phases.py) ----------------------
// Built with -DNFA_PHASES, each warp sums its clock between marks into
// per-phase totals, added over the launch into nfa_phase_cycles: 0 the
// next tile's copies issued, 1 the slot steps (steps 0-4), 2 the drain, 3
// the head, 4 the state in and out and the end drain, 5 the wait for a
// tile (and, for fused lanes, for the block's warps), 6 its hand-over
// into node words and flags.  The shipped libraries
// define no NFA_PHASES and carry none of it.
#ifdef NFA_PHASES
__device__ unsigned long long nfa_phase_cycles[7];
#define PHASE_MARK(k)                    \
  do {                                   \
    const long long now_ = clock64();    \
    ph_[k] += now_ - ph_t_;              \
    ph_t_ = now_;                        \
  } while (0)
extern "C" int nfa_block_phases(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, nfa_phase_cycles, sizeof(nfa_phase_cycles));
  if (e == cudaSuccess) {
    const unsigned long long zero[7] = {0, 0, 0, 0, 0, 0, 0};
    e = cudaMemcpyToSymbol(nfa_phase_cycles, zero, sizeof(zero));
  }
  return static_cast<int>(e);
}
#else
#define PHASE_MARK(k) \
  do {                \
  } while (0)
#endif

// ---- the event stage ------------------------------------------------------
constexpr int NST = 2;          // tiles in a ring
constexpr int TT = 64;          // steps a tile
constexpr int SPL = TT / 32;    // a lane's steps of a tile
// byte offsets of the fixed fields in a step (a field's TT entries sit at
// offset * TT in the tile); the columns follow at ev_soff, the pre-mask
// words at stage_pre
#define ST_TS 0
#define ST_SEQ 4
#define ST_SC 8
#define ST_NW 12                // node word
#define ST_VW 16                // the valid byte's word, then the flags
#define ST_TW 20                // the tick byte's word

// The block's stage header in shared memory: per column its pointer and
// (offset of its TT entries in a tile) << 3 | storage type; per node its
// pre-mask words (null: no pre-mask); in registers, which nodes have one
// and whether a column is BOOL.
struct StageHdr {
  const void* const* col;
  const unsigned* const* pre;
  const int* cd;
  unsigned has_pre;   // bit gi: node gi has a pre-mask
  bool any_bool;      // a BOOL column
};

__device__ __host__ __forceinline__ size_t stage_hdr_bytes(const NfaParams& p) {
  return (static_cast<size_t>(p.C + p.n_nodes) * 8 + static_cast<size_t>(p.C) * 4 + 7) / 8 * 8;
}

// A ring's bytes; shared memory ahead of the warps' parts: the programs,
// the header and, for fused lanes, the block's ring of broadcast rows.
__device__ __host__ __forceinline__ size_t ring_bytes(const NfaParams& p) {
  return static_cast<size_t>(NST) * TT * p.stage_step;
}

__device__ __host__ __forceinline__ size_t block_stage_bytes(const NfaParams& p) {
  return p.prog_bytes + stage_hdr_bytes(p) + (p.bcast ? ring_bytes(p) : 0);
}

// One staged step: the tile holding its event's fields and columns
// (`ev`: the block's tile under bcast, else the warp's), the warp's own
// tile (flags, node word, BOOL columns as 0/1) and the entry.
struct Ev {
  const unsigned char* ev;
  const unsigned char* own;
  int i;
  const int* cd;
};

// Column `col` of the staged step at its storage type (BOOL staged as a
// 4-byte 0/1); `vt` gets that type.
__device__ __forceinline__ VmVal ev_read(const Ev& e, int col, int& vt) {
  const int d = e.cd[col];
  vt = d & 7;
  const unsigned char* r = (vt == VT_BOOL ? e.own : e.ev) + (d >> 3);
  switch (vt) {
    case VT_BOOL:
    case VT_I32: return vm_i(reinterpret_cast<const int*>(r)[e.i]);
    case VT_I64: return vm_l(reinterpret_cast<const long long*>(r)[e.i]);
    case VT_F32: return vm_f(reinterpret_cast<const float*>(r)[e.i]);
    default: return vm_d(reinterpret_cast<const double*>(r)[e.i]);
  }
}

__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(s))),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(s))),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The block's live warps (`n` threads) meet: fused lanes share the
// block's ring (a warp past P has left the kernel and is not counted).
__device__ __forceinline__ void bar_live(int n) {
  asm volatile("barrier.sync 1, %0;\n" ::"r"(n) : "memory");
}

// A byte-wide grid entry is copied as the aligned 4-byte word holding it
// (a word never crosses the allocation the byte lies in) and picked out
// at the hand-over.
__device__ __forceinline__ const void* word_of(const unsigned char* b) {
  return reinterpret_cast<const void*>(reinterpret_cast<unsigned long long>(b) & ~3ull);
}

__device__ __forceinline__ unsigned byte_of(unsigned w, const unsigned char* b) {
  return (w >> (8 * (reinterpret_cast<unsigned long long>(b) & 3ull))) & 0xffu;
}

// The flat index of step t's event (`e`) and of its pre-mask bit (`pi`),
// and whether a chunk lane's event lies in the flush: the grid's (t,
// part), the broadcast row t, or a chunk lane's flat event part*cs + t
// clipped to the last.
template <bool CH>
__device__ __forceinline__ void stage_index(const NfaParams& p, int t, int part, long long& e,
                                            long long& pi, bool& in) {
  pi = static_cast<long long>(t) * p.P + part;
  e = p.bcast ? static_cast<long long>(t) : pi;
  in = true;
  if constexpr (CH) {
    if (p.chunk) {
      const long long f = static_cast<long long>(part) * p.cs + t;
      e = pi = f < p.nflat ? f : p.nflat - 1;
      in = f < p.nev;
    }
  }
}

// A thread's steps of a tile, s = first + stride * k (k < SPL), with
// their flat indices; `ok` marks those in the tile and below T.
struct Steps {
  int s[SPL];
  long long e[SPL], pi[SPL];
  bool in[SPL], ok[SPL];
};

template <bool CH>
__device__ __forceinline__ Steps steps_of(const NfaParams& p, int t0, int part, int first,
                                          int stride) {
  Steps st;
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    st.s[k] = first + stride * k;
    st.ok[k] = st.s[k] < TT && t0 + st.s[k] < p.T;
    stage_index<CH>(p, t0 + st.s[k], part, st.e[k], st.pi[k], st.in[k]);
  }
  return st;
}

// Issue the copies of steps t0 .. t0 + TT - 1 (those below T): the
// event's fields and columns into `ev` -- the warp's steps lane, lane + 32
// or, under bcast, the block's steps `tid`, tid + nthr, ... of the shared
// broadcast rows -- and the pre-mask words of the warp's lane into `own`;
// field by field, each field's pointer and place read once a call.
template <bool CH>
__device__ void stage_issue(const NfaParams& p, const StageHdr& h, unsigned char* ev,
                            unsigned char* own, int t0, int part, int lane, int tid, int nthr) {
  Steps st = steps_of<CH>(p, t0, part, p.bcast ? tid : lane, p.bcast ? nthr : 32);
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    if (!st.ok[k]) continue;
    const int s = st.s[k];
    const long long e = st.e[k];
    cp_async4(ev + ST_TS * TT + 4 * s, p.ts + e);
    cp_async4(ev + ST_SEQ * TT + 4 * s, p.seq + e);
    if (p.multi) cp_async4(ev + ST_SC * TT + 4 * s, p.scode + e);
    if (!(CH && p.chunk)) cp_async4(ev + ST_VW * TT + 4 * s, word_of(p.valid + e));
    if (p.tick != nullptr) cp_async4(ev + ST_TW * TT + 4 * s, word_of(p.tick + e));
  }
  for (int c = 0; c < p.C; ++c) {
    const int d = h.cd[c];
    unsigned char* r = ev + (d >> 3);
    const unsigned char* g = static_cast<const unsigned char*>(h.col[c]);
    const int vt = d & 7;
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      if (!st.ok[k]) continue;
      const int s = st.s[k];
      if (vt == VT_BOOL) cp_async4(r + 4 * s, word_of(g + st.e[k]));
      else if (vt == VT_I64 || vt == VT_F64) cp_async8(r + 8 * s, g + 8 * st.e[k]);
      else cp_async4(r + 4 * s, g + 4 * st.e[k]);
    }
  }
  if (p.bcast) st = steps_of<CH>(p, t0, part, lane, 32);
  for (unsigned m = h.has_pre; m != 0u; m &= m - 1u) {
    const int gi = __ffs(m) - 1;
    const unsigned* w = h.pre[gi];
    unsigned char* r = own + (p.stage_pre + 4 * gi) * TT;
#pragma unroll
    for (int k = 0; k < SPL; ++k)
      if (st.ok[k]) cp_async4(r + 4 * st.s[k], w + (st.pi[k] >> 5));
  }
  cp_async_commit();
}

// The hand-over of a landed tile: each lane turns its own steps' raw words
// into the warp's node word (1 for a node without a pre-mask), flags (bit
// 0 valid, bit 1 tick) and 0/1 BOOL columns in `own` (in place where
// `ev` is the warp's own tile).
template <bool CH>
__device__ void stage_prep(const NfaParams& p, const StageHdr& h, const unsigned char* ev,
                           unsigned char* own, int t0, int part, int lane) {
  const Steps st = steps_of<CH>(p, t0, part, lane, 32);
  unsigned nw[SPL];
#pragma unroll
  for (int k = 0; k < SPL; ++k) nw[k] = ~h.has_pre;
  for (unsigned m = h.has_pre; m != 0u; m &= m - 1u) {
    const int gi = __ffs(m) - 1;
    const unsigned* r = reinterpret_cast<const unsigned*>(own + (p.stage_pre + 4 * gi) * TT);
#pragma unroll
    for (int k = 0; k < SPL; ++k) nw[k] |= ((r[st.s[k]] >> (st.pi[k] & 31)) & 1u) << gi;
  }
  const unsigned* vw = reinterpret_cast<const unsigned*>(ev + ST_VW * TT);
  const unsigned* tw = reinterpret_cast<const unsigned*>(ev + ST_TW * TT);
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    if (!st.ok[k]) continue;
    const int s = st.s[k];
    const bool valid =
        (CH && p.chunk) ? st.in[k] : byte_of(vw[s], p.valid + st.e[k]) != 0u;
    const bool tick = p.tick != nullptr && byte_of(tw[s], p.tick + st.e[k]) != 0u;
    reinterpret_cast<unsigned*>(own + ST_NW * TT)[s] = nw[k];
    reinterpret_cast<unsigned*>(own + ST_VW * TT)[s] = (valid ? 1u : 0u) | (tick ? 2u : 0u);
  }
  if (!h.any_bool) return;
  for (int c = 0; c < p.C; ++c) {
    const int d = h.cd[c];
    if ((d & 7) != VT_BOOL) continue;
    const unsigned* raw = reinterpret_cast<const unsigned*>(ev + (d >> 3));
    unsigned* r = reinterpret_cast<unsigned*>(own + (d >> 3));
    const unsigned char* g = static_cast<const unsigned char*>(h.col[c]);
#pragma unroll
    for (int k = 0; k < SPL; ++k)
      if (st.ok[k]) r[st.s[k]] = byte_of(raw[st.s[k]], g + st.e[k]) != 0u;
  }
}

// VM environment of one slot at one event: the staged event's columns,
// then the slot's capture rows, then the event's ts offset; lane
// parameters at the warp's partition lane.
struct SlotEnv {
  const NfaParams& p;
  Ev ev;
  int a;
  int part;
  Caps c;
  int ts;
  __device__ VmVal load(int slot, int vt) {
    if (slot < p.C) {
      int have;
      const VmVal v = ev_read(ev, slot, have);
      return vm_as(v, have, vt);
    }
    slot -= p.C;
    if (slot < p.Kf) return VM_CAP(c.f[slot * p.A + a]);
    slot -= p.Kf;
    if (slot < p.Ki) return vm_as(vm_i(c.i[slot * p.A + a]), VT_I32, vt);
    slot -= p.Ki;
    if (slot < p.Kl) return vm_l(c.l[slot * p.A + a]);
    return vm_i(ts);
  }
  __device__ VmVal param(int i, int vt) {
    return vm_const(p.qparams[static_cast<long long>(i) * p.P + part], vt);
  }
};

// The event's own part of a node match: valid, its stream, its pre-mask
// (bit gi of the staged node word).
__device__ __forceinline__ bool base_match(const NfaParams& p, int gi, bool valid, int sc,
                                           unsigned nw) {
  return valid && (!p.multi || sc == p.node_scode[gi]) && ((nw >> gi) & 1u);
}

// One span of capture writes into slot a (the table of NFAKernel
// capture_values / count_capture_values): W_PREV entries come first, so
// [last-1] reads the old [last]; W_IDX and W_PRES_GE read only their own
// row.  With `comp`, the completion's ts and seq rows too.
__device__ void apply_writes(const NfaParams& p, int off, int len, int newc, Ev ev,
                             int a, Caps c, bool comp, int cts, int cseq) {
  for (int w = off; w < off + len; ++w) {
    const int r = p.w_row[w], g = p.w_group[w], mode = p.w_mode[w];
    const int gt = g == 0 ? CAP_VT : (g == 1 ? VT_I32 : VT_I64);
    void* base = g == 0 ? static_cast<void*>(c.f) : (g == 1 ? static_cast<void*>(c.i)
                                                             : static_cast<void*>(c.l));
    const long long at = static_cast<long long>(r) * p.A + a;
    VmVal v;
    if (mode == W_PREV) {
      v = vm_read(base, gt, static_cast<long long>(p.w_arg[w]) * p.A + a);
    } else if (mode == W_ONE) {
      v = vm_cast(vm_i(1), VT_I32, gt);
    } else if (mode == W_PRES_GE) {
      if (newc < p.w_arg[w]) continue;
      v = vm_cast(vm_i(1), VT_I32, gt);
    } else {
      if (mode == W_IDX && newc != p.w_arg[w]) continue;
      int vt;
      const VmVal x = ev_read(ev, p.w_src[w], vt);
      v = vm_cast(x, vt, gt);
    }
    vm_write(base, gt, at, v);
  }
  if (comp) {
    c.i[p.comp_ts_row * p.A + a] = cts;
    c.i[p.comp_seq_row * p.A + a] = cseq;
  }
}

__device__ __forceinline__ void zero_rows(const NfaParams& p, int off, int len, int a, Caps c) {
  for (int k = off; k < off + len; ++k) c.i[p.pz_rows[k] * p.A + a] = 0;
}

// Slot a entering position tp (_enter_position): a count starts collecting
// (a min-0 count below the final position arms its successor at once), a
// logical pair clears its fill bits, an absent position arms its deadline
// one waiting period after `at`.
template <bool ALG>
__device__ __forceinline__ void enter(const NfaParams& p, int tp, int a, int at, Caps c,
                                      unsigned& con, unsigned& nar, unsigned& flb) {
  const int kind = p.pos_kind[tp];
  if (ALG && kind == K_COUNT) {
    const int cr = p.pos_cnt[tp];
    c.c[cr * p.A + a] = 0;
    con |= 1u << cr;
    if (p.pos_min[tp] == 0 && tp < p.S - 1) nar |= 1u << cr;
    else nar &= ~(1u << cr);
  } else if (ALG && kind == K_LOGICAL) {
    flb &= ~(3u << (2 * p.pos_log[tp]));
  }
  const int r = p.pos_dl_row[tp];
  if (r >= 0)
    c.d[r * p.A + a] = static_cast<int>(static_cast<unsigned>(at) +
                                        static_cast<unsigned>(p.pos_waiting[tp]));
}

// The same for the EXT instantiation, where a logical position may hold
// an absent side: every absent node of the position with a waiting time
// arms its deadline (the per-position row above stays the chain and
// algebra steps' single load: reading the node tables there cost them
// 4-8% on C4 `seq` and C5).
__device__ __forceinline__ void enter_ext(const NfaParams& p, int tp, int a, int at, Caps c,
                                          unsigned& con, unsigned& nar, unsigned& flb) {
  const int kind = p.pos_kind[tp];
  enter<true>(p, tp, a, at, c, con, nar, flb);
  if (kind != K_LOGICAL) return;
  for (int g = p.pos_node[tp]; g < p.pos_node[tp] + 2; ++g) {
    const int r = p.node_dl[g];
    if (r >= 0)
      c.d[r * p.A + a] = static_cast<int>(static_cast<unsigned>(at) +
                                          static_cast<unsigned>(p.node_wait[g]));
  }
}

// Emit slot a's snapshot as match row `pos`.
__device__ void emit_slot(const NfaParams& p, int pos, int a, int hseq, int part, Caps c) {
  if (pos >= p.M) return;
  const long long M = p.M;
  for (int r = 0; r < p.Ki; ++r) p.out_i[r * M + pos] = c.i[r * p.A + a];
  p.out_i[p.Ki * M + pos] = hseq;
  if (p.emit_qid) p.out_i[(p.Ki + 1) * M + pos] = part;
  for (int r = 0; r < p.Kf; ++r) p.out_f[r * M + pos] = c.f[r * p.A + a];
  for (int r = 0; r < p.Kl; ++r) p.out_l[r * M + pos] = c.l[r * p.A + a];
}

// Single-position chains emit the head event directly (no slot).
__device__ void emit_single(const NfaParams& p, Ev ev, int ts, int seq, int part) {
  const int pos = atomicAdd(p.meta, 1);
  if (pos >= p.M) return;
  const long long M = p.M;
  for (int w = p.node_cw_off[0]; w < p.node_cw_off[0] + p.node_cw_len[0]; ++w) {
    const int g = p.w_group[w], r = p.w_row[w];
    const int gt = g == 0 ? CAP_VT : (g == 1 ? VT_I32 : VT_I64);
    VmVal v = vm_cast(vm_i(1), VT_I32, gt);
    if (p.w_mode[w] == W_SRC) {
      int vt;
      const VmVal x = ev_read(ev, p.w_src[w], vt);
      v = vm_cast(x, vt, gt);
    }
    if (g == 0) p.out_f[r * M + pos] = CAP_VAL(v);
    else if (g == 1) p.out_i[r * M + pos] = v.i;
    else p.out_l[r * M + pos] = v.l;
  }
  int r = p.Ki;
  p.out_i[r++ * M + pos] = seq;              // __head_seq__
  if (p.emit_qid) p.out_i[r++ * M + pos] = part;  // __qid__
  p.out_i[r++ * M + pos] = ts;               // __comp_ts__
  p.out_i[r * M + pos] = seq;                // __comp_seq__
}

// Drain: parked slots and in-place emissions (`now`), ranked by slot
// index; the first E emit, parked ones free; in-place emissions past E
// are returned as lost.
// Chunk lanes (CH instantiations, p.chunk set) rank the same way but
// write only the completions after the previous flush's last seq
// (prev_seq), so a replayed completion takes no row of M: the JAX block's
// dedup before its compaction.
template <int NJ, bool ALG, bool CH>
__device__ int drain(const NfaParams& p, int lane, int part, int (&occ)[NJ],
                     const int (&hsq)[NJ], const bool (&now)[NJ], Caps c) {
  const int PARK = p.S + 1;
  const unsigned lt = (1u << lane) - 1u;
  unsigned pb[NJ], kb[NJ];
  int tot = 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    pb[j] = __ballot_sync(FULL, occ[j] == PARK || (ALG && now[j]));
    kb[j] = 0u;
    tot += __popc(pb[j]);
  }
  if (tot == 0) return 0;
  int kept = tot < p.E ? tot : p.E;
  if (CH && p.chunk) {
    int before = 0;
    kept = 0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int rank = before + __popc(pb[j] & lt);
      const bool keep = ((pb[j] >> lane) & 1u) && rank < p.E &&
                        c.i[p.comp_seq_row * p.A + lane + 32 * j] > p.prev_seq;
      kb[j] = __ballot_sync(FULL, keep);
      kept += __popc(kb[j]);
      before += __popc(pb[j]);
    }
  }
  int base = 0;
  if (lane == 0 && (!CH || kept > 0)) base = atomicAdd(p.meta, kept);
  base = __shfl_sync(FULL, base, 0);
  int before = 0, kbefore = 0, lost = 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (occ[j] == PARK || (ALG && now[j])) {
      const int rank = before + __popc(pb[j] & lt);
      if (rank < p.E) {
        if (!(CH && p.chunk))
          emit_slot(p, base + rank, lane + 32 * j, hsq[j], part, c);
        else if ((kb[j] >> lane) & 1u)
          emit_slot(p, base + kbefore + __popc(kb[j] & lt), lane + 32 * j, hsq[j], part, c);
        if (occ[j] == PARK) occ[j] = 0;
      } else if (occ[j] != PARK) {
        ++lost;
      }
    }
    before += __popc(pb[j]);
    kbefore += __popc(kb[j]);
  }
  return lost;
}

// The step of one stationed slot on a chain of stream and absent positions
// (the instantiation without counts or logical positions): due deadlines
// fire first and walk the station forward, then only the station's node
// is matched, on captures that firing does not change -- the result of
// steps 1-4 of the algebra instantiation, which must match every later
// node ahead of the firing.  Returns the slot's new station.
__device__ __forceinline__ int chain_step(const NfaParams& p, const int* words,
                                          const long long* consts, int a, int part,
                                          Ev ev, unsigned nw, int ts, int seq,
                                          bool valid, bool timey, bool dl_fire, int sc, int o,
                                          int fts, Caps c) {
  const int A = p.A, S = p.S;
  unsigned none = 0u;
  bool fired = false;                    // the last (absent) position completed
  int fired_at = 0;
  if (dl_fire && p.Ka > 0) {
    while (true) {
      const int pi = o - 1;
      const int r = p.pos_dl_row[pi];
      if (p.pos_kind[pi] != K_ABSENT || r < 0) break;
      const int d = c.d[r * A + a];
      if (d > ts) break;                 // NO_DEADLINE never fires
      c.d[r * A + a] = NO_DEADLINE;
      if (pi == S - 1) {
        fired = true;
        fired_at = d;
        break;
      }
      o = pi + 2;
      enter<false>(p, pi + 1, a, d, c, none, none, none);
      zero_rows(p, p.pos_pz_off[pi + 1], p.pos_pz_len[pi + 1], a, c);
      const int pr = p.node_pres[p.pos_node[pi]];
      if (pr >= 0) c.i[pr * A + a] = 0;
    }
  }
  const int stn = o - 1;
  const int w = p.pos_within[stn];
  bool dead = w >= 0 && timey &&
              static_cast<int>(static_cast<unsigned>(ts) - static_cast<unsigned>(fts)) > w;
  bool trans = false;
  const int gi = p.pos_node[stn];
  if (!dead && stn >= 1 && base_match(p, gi, valid, sc, nw)) {
    bool m = true;
    if (p.node_prog_len[gi] > 0) {
      SlotEnv env{p, ev, a, part, c, ts};
      m = vm_run(words + p.node_prog_off[gi], p.node_prog_len[gi], consts, env).i != 0;
    }
    if (m && p.pos_kind[stn] == K_ABSENT) {
      dead = true;                       // a forbidden arrival
    } else if (m) {
      trans = true;
      apply_writes(p, p.node_cw_off[gi], p.node_cw_len[gi], 0, ev, a, c, true, ts, seq);
      if (stn == S - 1) {
        o = S + 1;
      } else {
        o = stn + 2;
        enter<false>(p, stn + 1, a, ts, c, none, none, none);
        zero_rows(p, p.pos_pz_off[stn + 1], p.pos_pz_len[stn + 1], a, c);
      }
    }
  }
  if (dead) {
    for (int r = 0; r < p.Ka; ++r) c.d[r * A + a] = NO_DEADLINE;
    return 0;
  }
  if (fired) {
    const int pr = p.node_pres[p.pos_node[S - 1]];
    if (pr >= 0) c.i[pr * A + a] = 0;
    c.i[p.comp_ts_row * A + a] = fired_at;
    c.i[p.comp_seq_row * A + a] = seq;
    o = S + 1;
  }
  if (p.is_seq && o > 0 && o <= S && fts != NO_FIRST && !trans && valid) o = 0;
  return o;
}

// ---- EXT: init slots, slot forking, absent sides of and/or -------------
// The step of a chain with an init slot, an `every` below the head or an
// absent side inside a logical position.  It runs the JAX step statement
// for statement, phase by phase over all of the thread's slots (the
// phases meet at each fork, a warp-wide exchange), with the capture
// writes deferred to the end of the step as JAX defers them: a clone then
// copies its source's rows as they were before the event, and the
// capture of the forking event goes to the clone alone.

// _fork_slots: the k-th source slot of the lane (by slot index) is cloned
// into its k-th free slot -- stations, anchors, count and fill bits from
// the source's registers (staged in the warp's fork rows), capture,
// counter and deadline rows column to column in shared memory.  `dst`
// marks the clones; clones without a free slot count into `ofs` (the
// plan grows A and re-runs the block) and `lostf` (this block's share).
template <int NJ>
__device__ void fork_slots(const NfaParams& p, int lane, const bool (&src)[NJ], bool (&dst)[NJ],
                           int (&occ)[NJ], int (&fts)[NJ], int (&hsq)[NJ], unsigned (&con)[NJ],
                           unsigned (&nar)[NJ], unsigned (&flb)[NJ], Caps c, int* fk, int& ofs,
                           int& lostf) {
  const int A = p.A;
  const unsigned lt = (1u << lane) - 1u;
  int total = 0, nfree = 0;
  for (int j = 0; j < NJ; ++j) {
    total += __popc(__ballot_sync(FULL, src[j]));
    nfree += __popc(__ballot_sync(FULL, occ[j] == 0));
    dst[j] = false;
  }
  if (total == 0) return;
  int* slot_of = fk;                     // source slot by rank
  int* st = fk + A;                      // staged registers [6][A]
  int before = 0;
  for (int j = 0; j < NJ; ++j) {
    const unsigned b = __ballot_sync(FULL, src[j]);
    if (src[j]) {
      const int a = lane + 32 * j;
      slot_of[before + __popc(b & lt)] = a;
      st[a] = occ[j];
      st[A + a] = fts[j];
      st[2 * A + a] = hsq[j];
      st[3 * A + a] = static_cast<int>(con[j]);
      st[4 * A + a] = static_cast<int>(nar[j]);
      st[5 * A + a] = static_cast<int>(flb[j]);
    }
    before += __popc(b);
  }
  __syncwarp();
  before = 0;
  for (int j = 0; j < NJ; ++j) {
    const unsigned b = __ballot_sync(FULL, occ[j] == 0);
    const int r = before + __popc(b & lt);
    if (occ[j] == 0 && r < total) {
      const int a = lane + 32 * j, s = slot_of[r];
      occ[j] = st[s];
      fts[j] = st[A + s];
      hsq[j] = st[2 * A + s];
      con[j] = static_cast<unsigned>(st[3 * A + s]);
      nar[j] = static_cast<unsigned>(st[4 * A + s]);
      flb[j] = static_cast<unsigned>(st[5 * A + s]);
      for (int k = 0; k < p.Kf; ++k) c.f[k * A + a] = c.f[k * A + s];
      for (int k = 0; k < p.Ki; ++k) c.i[k * A + a] = c.i[k * A + s];
      for (int k = 0; k < p.Kl; ++k) c.l[k * A + a] = c.l[k * A + s];
      for (int k = 0; k < p.Ka; ++k) c.d[k * A + a] = c.d[k * A + s];
      for (int k = 0; k < p.Kc; ++k) c.c[k * A + a] = c.c[k * A + s];
      dst[j] = true;
    }
    before += __popc(b);
  }
  __syncwarp();
  const int lost = total > nfree ? total - nfree : 0;
  ofs += lost;
  lostf += lost;
}

// One event of the EXT step for all of the warp's slots (nfa_block_plain
// is its vector form).  `init` is the lane's init-slot flag.
template <int NJ>
__device__ void ext_step(const NfaParams& p, const int* words, const long long* consts, int lane,
                         int part, Ev ev, unsigned nw, int ts, int seq, bool valid,
                         bool tick, bool timey, bool dl_fire, int sc, int (&occ)[NJ],
                         int (&fts)[NJ], int (&hsq)[NJ], unsigned (&con)[NJ], unsigned (&nar)[NJ],
                         unsigned (&flb)[NJ], bool (&now)[NJ], bool& init, int& ofs, int& lostf,
                         Caps c, int* fk) {
  const int A = p.A, S = p.S, PARK = S + 1;
  const int n_nodes = p.pos_node[S - 1] + (p.pos_kind[S - 1] == K_LOGICAL ? 2 : 1);
  // the lane's init slot, armed on its first event (or tick)
  if (p.needs_init && !init && (valid || (p.init_on_tick && tick))) {
    init = true;
    if (lane == 0) {
      const int arm = p.has_anchor ? p.anchor : ts;
      const int k0 = p.pos_kind[0];
      const int land = (k0 == K_ABSENT || k0 == K_LOGICAL) ? 0 : p.init_land;
      occ[0] = land + 1;
      for (int tp = 0; tp <= land; ++tp) enter_ext(p, tp, 0, arm, c, con[0], nar[0], flb[0]);
      hsq[0] = seq;
    }
  }
  // node matches of every slot (a slot free now may become a clone) on
  // the captures before the event, its age and its successor arms
  unsigned nm[NJ], narm0[NJ], enters[NJ], pcw[NJ], pcc[NJ];
  int age[NJ], stn[NJ], pre_at[NJ];
  bool complete[NJ], trans[NJ], expired[NJ], kill[NJ], pre[NJ], m[NJ], d2[NJ];
#pragma unroll (NJ <= 4 ? NJ : 1)
  for (int j = 0; j < NJ; ++j) {
    const int a = lane + 32 * j;
    nm[j] = narm0[j] = enters[j] = pcw[j] = pcc[j] = 0u;
    age[j] = pre_at[j] = 0;
    complete[j] = trans[j] = expired[j] = kill[j] = pre[j] = false;
    if (a >= A) continue;
    age[j] = static_cast<int>(static_cast<unsigned>(ts) - static_cast<unsigned>(fts[j]));
    narm0[j] = nar[j];
    for (int gi = 0; gi < n_nodes; ++gi) {
      bool mm = base_match(p, gi, valid, sc, nw);
      if (mm && p.node_prog_len[gi] > 0) {
        SlotEnv env{p, ev, a, part, c, ts};
        mm = vm_run(words + p.node_prog_off[gi], p.node_prog_len[gi], consts, env).i != 0;
      }
      if (mm) nm[j] |= 1u << gi;
    }
  }
  // 1. absent deadlines at or before the event fire first, position by
  //    position; an `every` absent forks a clone that advances while the
  //    standing arm re-arms one period after the fired deadline
  for (int pi = 0; pi < S; ++pi) {
    const int g = p.pos_node[pi];
    const int r = p.pos_kind[pi] == K_ABSENT ? p.node_dl[g] : -1;
    if (r < 0) continue;
    bool due[NJ], adv[NJ];
    for (int j = 0; j < NJ; ++j) {
      const int a = lane + 32 * j;
      due[j] = a < A && dl_fire && occ[j] == pi + 1 && c.d[r * A + a] <= ts;
      adv[j] = due[j];
    }
    const bool sticky = p.pos_sticky[pi] != 0;
    if (sticky) {
      fork_slots<NJ>(p, lane, due, adv, occ, fts, hsq, con, nar, flb, c, fk, ofs, lostf);
      const int w = p.node_wait[g];
      for (int j = 0; j < NJ; ++j)
        if (due[j]) {
          const int a = lane + 32 * j;
          c.d[r * A + a] = static_cast<int>(static_cast<unsigned>(c.d[r * A + a]) +
                                            static_cast<unsigned>(w >= 1 ? w : 1));
        }
    }
    for (int j = 0; j < NJ; ++j) {
      const int a = lane + 32 * j;
      if (adv[j]) {
        const int at = c.d[r * A + a];
        if (fts[j] == NO_FIRST) fts[j] = at;
        const int pr = p.node_pres[g];
        if (pi == S - 1) {
          complete[j] = pre[j] = true;
          pre_at[j] = at;
        } else {
          const int land = p.pos_land[pi];
          occ[j] = land + 1;
          for (int tp = pi + 1; tp <= land; ++tp) {
            enter_ext(p, tp, a, at, c, con[j], nar[j], flb[j]);
            zero_rows(p, p.pos_pz_off[tp], p.pos_pz_len[tp], a, c);
          }
          if (pr >= 0) c.i[pr * A + a] = 0;
        }
      }
      if (sticky ? adv[j] : due[j]) c.d[r * A + a] = NO_DEADLINE;
    }
  }
  // lazy, strict `within` expiry on the ages before the deadlines fired
  for (int j = 0; j < NJ; ++j) {
    const int o = occ[j];
    stn[j] = (o >= 1 && o <= S) ? o - 1 : -1;
    if (stn[j] >= 0 && p.pos_within[stn[j]] >= 0 && timey && age[j] > p.pos_within[stn[j]]) {
      expired[j] = true;
      stn[j] = -1;
    }
  }
  // 2. count collection (station-independent), adjacent-count entries
  for (int pi = 0; pi < (p.Kc > 0 ? S : 0); ++pi) {
    if (p.pos_kind[pi] != K_COUNT) continue;
    const int cr = p.pos_cnt[pi], gi = p.pos_node[pi];
    const bool adj = pi > 0 && p.pos_kind[pi - 1] == K_COUNT;
    const int pc = adj ? p.pos_cnt[pi - 1] : 0;
    for (int j = 0; j < NJ; ++j) {
      const int a = lane + 32 * j;
      if (a >= A) continue;
      const bool hit = (nm[j] >> gi) & 1u;
      const bool collect = ((con[j] >> cr) & 1u) && hit;
      const int newc = c.c[cr * A + a] + (collect ? 1 : 0);
      c.c[cr * A + a] = newc;
      if (collect) pcc[j] |= 1u << cr;
      if (!(newc < p.pos_max[pi])) con[j] &= ~(1u << cr);
      if (pi < S - 1 && collect && newc == p.pos_min[pi]) {
        nar[j] |= 1u << cr;
        for (int tp = pi + 1; tp < p.pos_land[pi]; ++tp) enters[j] |= 1u << tp;
      }
      trans[j] = trans[j] || collect;
      if (pi == S - 1 && collect && newc >= p.pos_min[pi]) complete[j] = true;
      if (adj && stn[j] == pi - 1 && ((narm0[j] >> pc) & 1u) && hit) {
        nar[j] &= ~(1u << pc);
        occ[j] = pi + 1;
        trans[j] = true;
        c.c[cr * A + a] = 1;              // the entry's write replaces the collection's
        pcc[j] |= 1u << cr;
        if (p.pos_max[pi] > 1) con[j] |= 1u << cr;
        else con[j] &= ~(1u << cr);
        zero_rows(p, p.pos_pz_off[pi], p.pos_pz_len[pi], a, c);
        if (p.pos_min[pi] <= 1) {
          if (pi == S - 1) complete[j] = true;
          else nar[j] |= 1u << cr;
        }
      }
    }
  }
  // 3. stations, position by position
  for (int pi = 0; pi < S; ++pi) {
    const int kind = p.pos_kind[pi];
    if (kind == K_COUNT || (pi == 0 && kind == K_STREAM)) continue;
    const int gi = p.pos_node[pi];
    if (kind == K_LOGICAL) {
      // an absent side kills an `and` on arrival and disarms an `or`
      // side; a side's deadline passage advances the pair
      const int sh = 2 * p.pos_log[pi];
      for (int j = 0; j < NJ; ++j) {
        const int a = lane + 32 * j;
        m[j] = false;
        if (a >= A) continue;
        const bool at = stn[j] == pi;
        unsigned bits = (flb[j] >> sh) & 3u, need = 0u;
        bool lkill = false, side_due = false;
        for (int ni = 0; ni < 2; ++ni) {
          const int g = gi + ni;
          const bool hit = at && ((nm[j] >> g) & 1u);
          if (p.node_absent[g]) {
            const int dr = p.node_dl[g];
            if (!p.pos_or[pi]) lkill = lkill || hit;
            else if (dr >= 0 && hit) c.d[dr * A + a] = NO_DEADLINE;
            if (dr >= 0 && at && dl_fire && c.d[dr * A + a] <= ts) {
              side_due = true;
              c.d[dr * A + a] = NO_DEADLINE;
            }
            continue;
          }
          need |= 1u << ni;
          if (hit) {
            bits |= 1u << ni;
            trans[j] = true;
            pcw[j] |= 1u << g;
          }
        }
        const bool filled = p.pos_or[pi] ? bits != 0u : (bits & need) == need;
        m[j] = at && (filled || side_due) && !lkill;
        trans[j] = trans[j] || m[j];
        if (m[j] || lkill)
          for (int g = gi; g < gi + 2; ++g)
            if (p.node_dl[g] >= 0) c.d[p.node_dl[g] * A + a] = NO_DEADLINE;
        flb[j] = (flb[j] & ~(3u << sh)) | ((m[j] ? 0u : bits) << sh);
        kill[j] = kill[j] || lkill;
      }
    } else if (kind == K_ABSENT) {
      const int dr = p.node_dl[gi];
      for (int j = 0; j < NJ; ++j) {
        m[j] = false;
        const bool arr = stn[j] == pi && ((nm[j] >> gi) & 1u);     // a forbidden arrival
        if (!arr) continue;
        if (!p.pos_sticky[pi]) kill[j] = true;
        else if (dr >= 0)                 // an `every` arm re-arms its wait
          c.d[dr * A + lane + 32 * j] = static_cast<int>(static_cast<unsigned>(ts) +
                                                         static_cast<unsigned>(p.node_wait[gi]));
      }
      continue;
    } else {
      // a (1,1) stream position: stationed here, or through an armed
      // predecessor count, walking back over optional counts
      for (int j = 0; j < NJ; ++j) {
        bool elig = stn[j] == pi;
        unsigned chain = 0u;
        for (int q = pi - 1; q >= 0 && p.pos_kind[q] == K_COUNT; --q) {
          const int cq = p.pos_cnt[q];
          chain |= 1u << cq;
          if (stn[j] == q && ((narm0[j] >> cq) & 1u)) elig = true;
          if (p.pos_min[q] != 0) break;
        }
        m[j] = elig && ((nm[j] >> gi) & 1u);
        if (m[j]) {
          nar[j] &= ~chain;
          trans[j] = true;
        }
      }
      if (p.pos_sticky[pi]) {
        // `every` below the head: the slot stays a standing arm, a clone
        // advances with the capture
        fork_slots<NJ>(p, lane, m, d2, occ, fts, hsq, con, nar, flb, c, fk, ofs, lostf);
        for (int j = 0; j < NJ; ++j) {
          m[j] = d2[j];
          trans[j] = trans[j] || d2[j];
        }
      }
      for (int j = 0; j < NJ; ++j)
        if (m[j]) pcw[j] |= 1u << gi;
    }
    for (int j = 0; j < NJ; ++j) {      // advance
      if (!m[j]) continue;
      if (pi == S - 1) {
        complete[j] = true;
      } else {
        const int land = p.pos_land[pi];
        for (int tp = pi + 1; tp <= land; ++tp) enters[j] |= 1u << tp;
        occ[j] = land + 1;
      }
    }
  }
  // 4. death, the deferred capture writes, completion, entries, the
  //    within anchor of an init slot, sequence strictness
  const int final_cnt = p.pos_kind[S - 1] == K_COUNT ? p.pos_cnt[S - 1] : -1;
  for (int j = 0; j < NJ; ++j) {
    const int a = lane + 32 * j;
    now[j] = false;
    if (a >= A) continue;
    const bool dead = expired[j] || kill[j];
    if (dead) {
      occ[j] = 0;
      con[j] = nar[j] = 0u;
      for (int r = 0; r < p.Ka; ++r) c.d[r * A + a] = NO_DEADLINE;
      complete[j] = false;
    } else {
      if (pre[j]) {
        const int pr = p.node_pres[p.pos_node[S - 1]];
        if (pr >= 0) c.i[pr * A + a] = 0;
        c.i[p.comp_ts_row * A + a] = pre_at[j];
        c.i[p.comp_seq_row * A + a] = seq;
      }
      for (int pi = 0; pcc[j] != 0u && pi < S; ++pi) {
        if (p.pos_kind[pi] != K_COUNT || !((pcc[j] >> p.pos_cnt[pi]) & 1u)) continue;
        const int gi = p.pos_node[pi];
        apply_writes(p, p.node_cc_off[gi], p.node_cc_len[gi], c.c[p.pos_cnt[pi] * A + a], ev,
                     a, c, pi == S - 1, ts, seq);
      }
      for (unsigned rest = pcw[j]; rest != 0u; rest &= rest - 1u) {
        const int gi = __ffs(rest) - 1;
        apply_writes(p, p.node_cw_off[gi], p.node_cw_len[gi], 0, ev, a, c, true, ts, seq);
      }
    }
    const bool survivor = final_cnt >= 0 && ((con[j] >> final_cnt) & 1u);
    if (complete[j] && !survivor) {
      occ[j] = PARK;
      con[j] = nar[j] = 0u;
    }
    now[j] = complete[j] && survivor;
    if (!dead)
      for (unsigned rest = enters[j]; rest != 0u; rest &= rest - 1u) {
        const int tp = __ffs(rest) - 1;
        enter_ext(p, tp, a, ts, c, con[j], nar[j], flb[j]);
        zero_rows(p, p.pos_pz_off[tp], p.pos_pz_len[tp], a, c);
      }
    if (p.needs_init && trans[j] && fts[j] == NO_FIRST) fts[j] = ts;
    if (p.is_seq && occ[j] > 0 && occ[j] < PARK && fts[j] != NO_FIRST && !trans[j] && valid) {
      occ[j] = 0;
      con[j] = nar[j] = 0u;
    }
  }
}

// A new head's slot entering position tp.
template <bool ALG, bool EXT>
__device__ __forceinline__ void head_enter(const NfaParams& p, int tp, int a, int at, Caps c,
                                           unsigned& con, unsigned& nar, unsigned& flb) {
  if constexpr (EXT) enter_ext(p, tp, a, at, c, con, nar, flb);
  else enter<ALG>(p, tp, a, at, c, con, nar, flb);
}

template <int NJ, bool ALG, bool EXT, bool CH>
__global__ void nfa_block_kernel(const __grid_constant__ NfaParams p) {
  extern __shared__ long long smem[];
  const int* words = p.words;
  const long long* consts = p.consts;
  if (p.stage) vm_stage(p.words, p.n_words, p.consts, p.n_consts, smem, &words, &consts);
  // the stage header after the programs: column and pre-mask pointers,
  // column descriptors
  StageHdr h;
  {
    long long* hb = smem + p.prog_bytes / 8;
    const void** col = reinterpret_cast<const void**>(hb);
    const unsigned** pre = reinterpret_cast<const unsigned**>(hb + p.C);
    int* cd = reinterpret_cast<int*>(hb + p.C + p.n_nodes);
    for (int i = threadIdx.x; i < p.C; i += blockDim.x) {
      col[i] = p.ev[i];
      cd[i] = (p.ev_soff[i] * TT) << 3 | p.ev_vt[i];
    }
    for (int i = threadIdx.x; i < p.n_nodes; i += blockDim.x) pre[i] = p.node_pre[i];
    __syncthreads();
    h.col = col;
    h.pre = pre;
    h.cd = cd;
    h.has_pre = 0u;
    h.any_bool = false;
    for (int i = 0; i < p.n_nodes; ++i)
      if (p.node_pre[i] != nullptr) h.has_pre |= 1u << i;
    for (int i = 0; i < p.C; ++i) h.any_bool |= p.ev_vt[i] == VT_BOOL;
  }
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int part = blockIdx.x * p.wpb + wib;
  if (part >= p.P) return;               // whole warp leaves together
  const int A = p.A, P = p.P, S = p.S, PARK = S + 1;
  const int n_nodes = p.pos_node[S - 1] + (p.pos_kind[S - 1] == K_LOGICAL ? 2 : 1);
  const unsigned all_nodes = n_nodes >= 32 ? 0xffffffffu : ((1u << n_nodes) - 1u);
  // the warp's ring of NST tiles, then its rows; fused lanes' broadcast
  // rows in the block's ring (after the header), read by every warp
  const int tile_bytes = TT * p.stage_step;
  long long* wbase = smem + block_stage_bytes(p) / 8 + static_cast<size_t>(wib) * p.warp_words;
  unsigned char* ring = reinterpret_cast<unsigned char*>(wbase);
  unsigned char* ev_ring =
      p.bcast ? reinterpret_cast<unsigned char*>(smem + (p.prog_bytes + stage_hdr_bytes(p)) / 8)
              : ring;
  const int rest = P - static_cast<int>(blockIdx.x) * p.wpb;   // live warps
  const int live = 32 * (rest < p.wpb ? rest : p.wpb);
  Caps c;                                // the f rows follow the 8-byte l
  c.l = wbase + NST * tile_bytes / 8;    // rows: doubles stay aligned
  c.f = reinterpret_cast<capf_t*>(c.l + static_cast<size_t>(p.Kl) * A);
  c.i = reinterpret_cast<int*>(c.f + static_cast<size_t>(p.Kf) * A);
  c.d = c.i + static_cast<size_t>(p.Ki) * A;
  c.c = c.d + static_cast<size_t>(p.Ka) * A;
  int* fk = c.c + static_cast<size_t>(p.Kc) * A;   // EXT: the fork rows

  int occ[NJ], fts[NJ], hsq[NJ];
  unsigned con[NJ], nar[NJ], flb[NJ];
  bool now[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int a = lane + 32 * j;
    occ[j] = -1;                         // not a slot: never free, never parked
    fts[j] = hsq[j] = 0;
    con[j] = nar[j] = flb[j] = 0u;
    now[j] = false;
    if (a < A) {
      const long long g = static_cast<long long>(a) * P + part;
      occ[j] = p.occ_in[g];
      fts[j] = p.first_in[g];
      hsq[j] = p.hseq_in[g];
      for (int k = 0; k < (ALG ? p.Kc : 0); ++k) {
        const long long gk = (static_cast<long long>(k) * A + a) * P + part;
        c.c[k * A + a] = p.cnt_in[gk];
        if (p.con_in[gk]) con[j] |= 1u << k;
        if (p.narm_in[gk]) nar[j] |= 1u << k;
      }
      for (int k = 0; k < (ALG ? p.Klog : 0); ++k)
        flb[j] |= (static_cast<unsigned>(p.fl_in[(static_cast<long long>(k) * A + a) * P + part]) & 3u)
                  << (2 * k);
      for (int k = 0; k < p.Kf; ++k) c.f[k * A + a] = p.capf_in[(static_cast<long long>(k) * A + a) * P + part];
      for (int k = 0; k < p.Ki; ++k) c.i[k * A + a] = p.capi_in[(static_cast<long long>(k) * A + a) * P + part];
      for (int k = 0; k < p.Kl; ++k) c.l[k * A + a] = p.capl_in[(static_cast<long long>(k) * A + a) * P + part];
      for (int k = 0; k < p.Ka; ++k) c.d[k * A + a] = p.dl_in[(static_cast<long long>(k) * A + a) * P + part];
    }
  }
  bool armed = p.armed_in[part] != 0;
  bool init = p.init_in != nullptr && p.init_in[part] != 0;
  int ofs = p.ofs_in[part];
  int ofl = p.ofl_in[part];
  int lostf = 0;
  const int final_cnt = p.pos_kind[S - 1] == K_COUNT ? p.pos_cnt[S - 1] : -1;
#ifdef NFA_PHASES
  long long ph_[7] = {0, 0, 0, 0, 0, 0, 0};
  long long ph_t_ = clock64();
#endif

  // tile 0 goes out before the first step, tile k + 1 at tile k's start
  if (p.T > 0) stage_issue<CH>(p, h, ev_ring, ring, 0, part, lane, threadIdx.x, live);
  const unsigned char *ev_tile = ev_ring, *own = ring;

  PHASE_MARK(4);
  for (int t = 0; t < p.T; ++t) {
    PHASE_MARK(3);
    const int i = t & (TT - 1);          // the step's entry in its tile
    if (i == 0) {
      // the hand-over: tile k has landed (every thread's copies, under
      // bcast, once the block has met), and every warp is done with tile
      // k - 1, whose slot takes tile k + 1
      const int k = t / TT;
      cp_async_wait_all();
      if (p.bcast) bar_live(live);
      else __syncwarp();
      PHASE_MARK(5);
      const int next = (k + 1) % NST * tile_bytes, cur = k % NST * tile_bytes;
      if (t + TT < p.T)
        stage_issue<CH>(p, h, ev_ring + next, ring + next, t + TT, part, lane, threadIdx.x, live);
      PHASE_MARK(0);
      stage_prep<CH>(p, h, ev_ring + cur, ring + cur, t, part, lane);
      __syncwarp();
      ev_tile = ev_ring + cur;
      own = ring + cur;
      PHASE_MARK(6);
    }
    const Ev ev{ev_tile, own, i, h.cd};
    const int ts = reinterpret_cast<const int*>(ev_tile + ST_TS * TT)[i];
    const int seq = reinterpret_cast<const int*>(ev_tile + ST_SEQ * TT)[i];
    const unsigned fl = reinterpret_cast<const unsigned*>(own + ST_VW * TT)[i];
    const unsigned nw = reinterpret_cast<const unsigned*>(own + ST_NW * TT)[i];
    const bool valid = (fl & 1u) != 0u;
    const bool tick = (fl & 2u) != 0u;
    const bool timey = valid || tick;
    const bool dl_fire = p.playback ? timey : tick;
    const int sc = p.multi ? reinterpret_cast<const int*>(ev_tile + ST_SC * TT)[i] : 0;

    if constexpr (EXT)
      ext_step<NJ>(p, words, consts, lane, part, ev, nw, ts, seq, valid, tick, timey,
                   dl_fire, sc, occ, fts, hsq, con, nar, flb, now, init, ofs, lostf, c, fk);
#pragma unroll (NJ <= 4 ? NJ : 1)
    for (int j = 0; j < (EXT ? 0 : NJ); ++j) {
      now[j] = false;
      const int a = lane + 32 * j;
      if (a >= A) continue;
      if constexpr (!ALG) {
        if (occ[j] >= 1 && occ[j] <= S)
          occ[j] = chain_step(p, words, consts, a, part, ev, nw, ts, seq, valid, timey,
                              dl_fire, sc, occ[j], fts[j], c);
        continue;
      }
      int o = occ[j];
      // a slot neither stationed nor collecting does nothing this event
      if ((o < 1 || o > S) && con[j] == 0u) continue;
      // 0. node matches on the captures before the event, for the nodes
      //    the slot can use: its station's, and with counts or deadlines
      //    every later node (reached through armed or adjacent counts, or
      //    a deadline firing before the event) and the nodes of the
      //    counts still collecting
      unsigned need = 0u;
      if (o >= 1 && o <= S) {
        const int first = p.pos_node[o - 1];
        need = (p.Kc > 0 || p.Ka > 0)
                   ? (all_nodes & ~((1u << first) - 1u))
                   : ((p.pos_kind[o - 1] == K_LOGICAL ? 3u : 1u) << first);
      }
      if (con[j] != 0u)
        for (int pi = 0; pi < S; ++pi)
          if (p.pos_kind[pi] == K_COUNT && ((con[j] >> p.pos_cnt[pi]) & 1u))
            need |= 1u << p.pos_node[pi];
      unsigned nm = 0u;
      for (unsigned rest = need; rest != 0u; rest &= rest - 1u) {
        const int gi = __ffs(rest) - 1;
        bool m = base_match(p, gi, valid, sc, nw);
        if (m && p.node_prog_len[gi] > 0) {
          SlotEnv env{p, ev, a, part, c, ts};
          m = vm_run(words + p.node_prog_off[gi], p.node_prog_len[gi], consts, env).i != 0;
        }
        if (m) nm |= 1u << gi;
      }
      // 1. absent deadlines due before the event, expiry, forbidden arrivals
      bool complete = false, pre_fired = false;
      int pre_at = 0;
      if (dl_fire && p.Ka > 0) {
        for (int pi = 0; pi < S; ++pi) {
          const int r = p.pos_dl_row[pi];
          if (p.pos_kind[pi] != K_ABSENT || r < 0 || o != pi + 1) continue;
          const int d = c.d[r * A + a];
          if (d > ts) continue;            // NO_DEADLINE never fires
          if (pi == S - 1) {
            complete = pre_fired = true;
            pre_at = d;
          } else {
            const int land = p.pos_land[pi];
            o = land + 1;
            for (int tp = pi + 1; tp <= land; ++tp) {
              enter<ALG>(p, tp, a, d, c, con[j], nar[j], flb[j]);
              zero_rows(p, p.pos_pz_off[tp], p.pos_pz_len[tp], a, c);
            }
            const int pr = p.node_pres[p.pos_node[pi]];
            if (pr >= 0) c.i[pr * A + a] = 0;
          }
          c.d[r * A + a] = NO_DEADLINE;
        }
      }
      const int stn = (o >= 1 && o <= S) ? o - 1 : -1;
      bool at = stn >= 0, expired = false;
      if (at && p.pos_within[stn] >= 0 && timey &&
          static_cast<int>(static_cast<unsigned>(ts) - static_cast<unsigned>(fts[j])) >
              p.pos_within[stn]) {
        expired = true;
        at = false;
      }
      const bool kill = at && p.pos_kind[stn] == K_ABSENT && ((nm >> p.pos_node[stn]) & 1u);
      const bool dead = expired || kill;
      if (pre_fired && !dead) {
        const int pr = p.node_pres[p.pos_node[S - 1]];
        if (pr >= 0) c.i[pr * A + a] = 0;
        c.i[p.comp_ts_row * A + a] = pre_at;
        c.i[p.comp_seq_row * A + a] = seq;
      }
      const unsigned narm0 = nar[j];
      bool trans = false;
      unsigned enters = 0u;
      // 2. count collection
      for (int pi = 0; pi < (p.Kc > 0 ? S : 0); ++pi) {
        if (p.pos_kind[pi] != K_COUNT) continue;
        const int cr = p.pos_cnt[pi], gi = p.pos_node[pi];
        const bool hit = (nm >> gi) & 1u;
        const bool collect = ((con[j] >> cr) & 1u) && hit;
        const int newc = c.c[cr * A + a] + (collect ? 1 : 0);
        const bool adj = pi > 0 && p.pos_kind[pi - 1] == K_COUNT;
        const int pc = adj ? p.pos_cnt[pi - 1] : 0;
        const bool ent = adj && at && stn == pi - 1 && ((narm0 >> pc) & 1u) && hit;
        if (collect && !ent && !dead)
          apply_writes(p, p.node_cc_off[gi], p.node_cc_len[gi], newc, ev, a, c, pi == S - 1,
                       ts, seq);
        c.c[cr * A + a] = newc;
        if (!(newc < p.pos_max[pi])) con[j] &= ~(1u << cr);
        if (pi < S - 1 && collect && newc == p.pos_min[pi]) {
          nar[j] |= 1u << cr;
          for (int tp = pi + 1; tp < p.pos_land[pi]; ++tp) enters |= 1u << tp;
        }
        trans = trans || collect;
        if (pi == S - 1 && collect && newc >= p.pos_min[pi]) complete = true;
        if (ent) {
          nar[j] &= ~(1u << pc);
          o = pi + 1;
          trans = true;
          c.c[cr * A + a] = 1;
          if (p.pos_max[pi] > 1) con[j] |= 1u << cr;
          else con[j] &= ~(1u << cr);
          zero_rows(p, p.pos_pz_off[pi], p.pos_pz_len[pi], a, c);
          if (!dead)
            apply_writes(p, p.node_cc_off[gi], p.node_cc_len[gi], 1, ev, a, c, pi == S - 1,
                         ts, seq);
          if (p.pos_min[pi] <= 1) {
            if (pi == S - 1) complete = true;
            else nar[j] |= 1u << cr;
          }
        }
      }
      // 3. stations: only the slot's own, and with counts those after it
      //    (an armed count makes its successor eligible)
      for (int pi = at ? stn : S; pi < (p.Kc > 0 ? S : stn + 1); ++pi) {
        const int kind = p.pos_kind[pi];
        if (kind == K_COUNT || kind == K_ABSENT || (pi == 0 && kind != K_LOGICAL)) continue;
        const int gi = p.pos_node[pi];
        const bool at_pi = at && stn == pi;
        bool m;
        if (kind == K_LOGICAL) {
          const int sh = 2 * p.pos_log[pi];
          unsigned bits = (flb[j] >> sh) & 3u;
          for (int ni = 0; ni < 2; ++ni) {
            if (!(at_pi && ((nm >> (gi + ni)) & 1u))) continue;
            bits |= 1u << ni;
            trans = true;
            if (!dead)
              apply_writes(p, p.node_cw_off[gi + ni], p.node_cw_len[gi + ni], 0, ev, a, c,
                           true, ts, seq);
          }
          m = at_pi && (p.pos_or[pi] ? bits != 0u : bits == 3u);
          flb[j] = (flb[j] & ~(3u << sh)) | ((m ? 0u : bits) << sh);
        } else {
          bool elig = at_pi;
          unsigned chain = 0u;
          for (int q = pi - 1; q >= 0 && p.pos_kind[q] == K_COUNT; --q) {
            const int cq = p.pos_cnt[q];
            chain |= 1u << cq;
            if (at && stn == q && ((narm0 >> cq) & 1u)) elig = true;
            if (p.pos_min[q] != 0) break;
          }
          m = elig && ((nm >> gi) & 1u);
          if (m) {
            nar[j] &= ~chain;
            if (!dead)
              apply_writes(p, p.node_cw_off[gi], p.node_cw_len[gi], 0, ev, a, c, true, ts,
                           seq);
          }
        }
        if (m) {                          // advance
          trans = true;
          if (pi == S - 1) {
            complete = true;
          } else {
            const int land = p.pos_land[pi];
            for (int tp = pi + 1; tp <= land; ++tp) enters |= 1u << tp;
            o = land + 1;
          }
        }
      }
      // 4. death, completion, entries, sequence strictness
      if (dead) {
        o = 0;
        con[j] = nar[j] = 0u;
        for (int r = 0; r < p.Ka; ++r) c.d[r * A + a] = NO_DEADLINE;
        complete = false;
      }
      const bool survivor = final_cnt >= 0 && ((con[j] >> final_cnt) & 1u);
      if (complete && !survivor) {
        o = PARK;
        con[j] = nar[j] = 0u;
      }
      now[j] = complete && survivor;
      if (!dead) {
        for (int tp = 0; tp < S; ++tp) {
          if (!((enters >> tp) & 1u)) continue;
          enter<ALG>(p, tp, a, ts, c, con[j], nar[j], flb[j]);
          zero_rows(p, p.pos_pz_off[tp], p.pos_pz_len[tp], a, c);
        }
      }
      if (p.is_seq && o > 0 && o < PARK && fts[j] != NO_FIRST && !trans && valid) {
        o = 0;
        con[j] = nar[j] = 0u;
      }
      occ[j] = o;
    }

    // 5. drain lanes
    PHASE_MARK(1);
    if (p.parked) {
      const int lost = drain<NJ, ALG, CH>(p, lane, part, occ, hsq, now, c);
      if constexpr (ALG) ofl += __reduce_add_sync(FULL, lost);
    }
    PHASE_MARK(2);

    // 6. head
    // (a disarmed one-shot head reads no pre-mask; an init-slot chain
    // has no head allocation, its entry being the init slot)
    // (a chunk lane arms heads in its own range t < cs only)
    const bool ok0 = !(EXT && p.needs_init) && armed && (!(CH && p.chunk) || t < p.cs) &&
                     (base_match(p, 0, valid, sc, nw) ||
                      (ALG && p.pos_kind[0] == K_LOGICAL && base_match(p, 1, valid, sc, nw)));
    if (!ok0) continue;
    if (!p.every_head) armed = false;
    if (!p.parked) {
      if (lane == 0 && (!CH || seq > p.prev_seq)) emit_single(p, ev, ts, seq, part);
      continue;
    }
    int hot = -1;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const unsigned fb = __ballot_sync(FULL, occ[j] == 0);
      if (hot < 0 && fb != 0u) hot = 32 * j + __ffs(fb) - 1;
    }
    if (hot < 0) {
      ++ofs;
      continue;
    }
#pragma unroll (NJ <= 4 ? NJ : 1)
    for (int j = 0; j < NJ; ++j) {
      if (hot != lane + 32 * j) continue;
      const int a = hot;
      fts[j] = ts;
      hsq[j] = seq;
      zero_rows(p, p.all_pz_off, p.all_pz_len, a, c);
      for (int r = 0; r < p.Ka; ++r) c.d[r * A + a] = NO_DEADLINE;
      const int land = S > 1 ? p.pos_land[0] : 0;
      const int kind = p.pos_kind[0];
      int o;
      if (ALG && kind == K_LOGICAL) {
        unsigned bits = 0u;
        for (int ni = 0; ni < 2; ++ni) {
          if (!base_match(p, ni, valid, sc, nw)) continue;
          bits |= 1u << ni;
          apply_writes(p, p.node_cw_off[ni], p.node_cw_len[ni], 0, ev, a, c, true, ts, seq);
        }
        const int sh = 2 * p.pos_log[0];
        flb[j] = (flb[j] & ~(3u << sh)) | (bits << sh);
        o = 1;
        if (p.pos_or[0] && bits != 0u) {
          o = S == 1 ? PARK : land + 1;
          if (S > 1)
            for (int tp = 1; tp <= land; ++tp) head_enter<ALG, EXT>(p, tp, a, ts, c, con[j], nar[j], flb[j]);
        }
      } else if (ALG && kind == K_COUNT) {
        const int cr = p.pos_cnt[0];
        o = 1;
        c.c[cr * A + a] = 1;
        if (p.pos_max[0] > 1) con[j] |= 1u << cr;
        else con[j] &= ~(1u << cr);
        if (S > 1) {
          if (p.pos_min[0] <= 1) nar[j] |= 1u << cr;
          else nar[j] &= ~(1u << cr);
        }
        apply_writes(p, p.node_cc_off[0], p.node_cc_len[0], 1, ev, a, c, S == 1, ts, seq);
        if (S == 1 && p.pos_min[0] <= 1) o = PARK;
      } else {
        o = land + 1;
        apply_writes(p, p.node_cw_off[0], p.node_cw_len[0], 0, ev, a, c, false, ts, seq);
        if (S > 1)
          for (int tp = 1; tp <= land; ++tp) head_enter<ALG, EXT>(p, tp, a, ts, c, con[j], nar[j], flb[j]);
      }
      occ[j] = o;
    }
  }
  PHASE_MARK(3);
  if (p.parked) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) now[j] = false;
    const int rounds = (A + p.E - 1) / p.E;
    for (int r = 0; r < rounds; ++r) drain<NJ, ALG, CH>(p, lane, part, occ, hsq, now, c);
  }

  int min_dl = NO_DEADLINE;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int a = lane + 32 * j;
    if (a >= A) continue;
    const long long g = static_cast<long long>(a) * P + part;
    p.occ_out[g] = occ[j];
    p.first_out[g] = fts[j];
    p.hseq_out[g] = hsq[j];
    for (int k = 0; k < (ALG ? p.Kc : 0); ++k) {
      const long long gk = (static_cast<long long>(k) * A + a) * P + part;
      p.cnt_out[gk] = c.c[k * A + a];
      p.con_out[gk] = (con[j] >> k) & 1u;
      p.narm_out[gk] = (nar[j] >> k) & 1u;
    }
    for (int k = 0; k < (ALG ? p.Klog : 0); ++k)
      p.fl_out[(static_cast<long long>(k) * A + a) * P + part] = (flb[j] >> (2 * k)) & 3u;
    for (int k = 0; k < p.Kf; ++k) p.capf_out[(static_cast<long long>(k) * A + a) * P + part] = c.f[k * A + a];
    for (int k = 0; k < p.Ki; ++k) p.capi_out[(static_cast<long long>(k) * A + a) * P + part] = c.i[k * A + a];
    for (int k = 0; k < p.Kl; ++k) p.capl_out[(static_cast<long long>(k) * A + a) * P + part] = c.l[k * A + a];
    const bool live = occ[j] >= 1 && occ[j] <= S;
    for (int k = 0; k < p.Ka; ++k) {
      const int d = c.d[k * A + a];
      p.dl_out[(static_cast<long long>(k) * A + a) * P + part] = d;
      if (live && d < min_dl) min_dl = d;
    }
  }
  min_dl = __reduce_min_sync(FULL, min_dl);
  if (lane == 0) {
    p.armed_out[part] = armed;
    if (p.init_out != nullptr) p.init_out[part] = init;
    p.ofs_out[part] = ofs;
    p.ofl_out[part] = ofl;
    atomicAdd(p.meta + 1, ofs);
    atomicAdd(p.meta + 3, ofl);
    if (lostf) atomicAdd(p.meta + 4, lostf);
    if (min_dl != NO_DEADLINE) atomicMin(p.meta + 2, min_dl);
  }
#ifdef NFA_PHASES
  PHASE_MARK(4);
  if (lane == 0)
    for (int k = 0; k < 7; ++k)
      atomicAdd(nfa_phase_cycles + k, static_cast<unsigned long long>(ph_[k]));
#endif
}

template <int NJ, bool ALG, bool EXT, bool CH>
static int launch_as(NfaParams& p, cudaStream_t stream) {
  const size_t smem = block_stage_bytes(p) + static_cast<size_t>(p.warp_words) * 8 * p.wpb;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(nfa_block_kernel<NJ, ALG, EXT, CH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (p.P + p.wpb - 1) / p.wpb;
  nfa_block_kernel<NJ, ALG, EXT, CH><<<blocks, 32 * p.wpb, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// A chain with an init slot, a fork or an absent logical side runs the
// EXT instantiation (built from its own sources, nfa_block_ext.cu and
// nfa_block_wide_ext.cu, so that nvcc compiles it beside the others);
// one with a count or logical position the algebra instantiation; any
// other, the chain step (same results, fewer node matches and no count
// or fill-bit state).
template <int NJ, bool EXT, bool CH>
static int launch(NfaParams& p, cudaStream_t stream) {
  if constexpr (EXT) {
    return launch_as<NJ, true, true, CH>(p, stream);
  } else {
    if (p.Kc > 0 || p.Klog > 0) return launch_as<NJ, true, false, CH>(p, stream);
    return launch_as<NJ, false, false, CH>(p, stream);
  }
}

// The launch's geometry: a warp's shared memory (warp_words, 8-byte
// units: its ring, then its rows) and the warps a block (up to 4 within
// 96 KB: one warp a block, spread over more SMs where P is small,
// measured 2-3% slower at C3K and C3X and no faster at C5); false when
// the programs, the header, the block's ring (fused lanes), a warp's ring
// and its rows do not fit the block's 227 KB (a double row takes
// CAP_WORDS = 2 words, so the `_f64` sources reach the limit at a smaller
// A) -- the launch then fails, as there is no unstaged form of the kernel.
static bool nfa_setup(NfaParams& p) {
  if (p.Kc > 32 || p.Klog > 16 || p.n_nodes > 32 || p.stage_step <= 0) return false;
  p.prog_bytes = (p.prog_bytes + 7) / 8 * 8;
  const size_t rows = static_cast<size_t>(p.Kl) * p.A +
                      (static_cast<size_t>(p.Kf * CAP_WORDS + p.Ki + p.Ka + p.Kc +
                                           (p.ext ? 7 : 0)) * p.A + 1) / 2;
  const size_t base = block_stage_bytes(p);
  const size_t warp = ring_bytes(p) + rows * 8;
  if (base + warp > 227 * 1024) return false;
  int wpb = 4;
  while (wpb > 1 && base + warp * wpb > 96 * 1024) wpb >>= 1;
  p.tt = TT;
  p.wpb = wpb;
  p.warp_words = static_cast<int>(warp / 8);
  return true;
}

// The launch entries: 1-4 slots a thread (A up to 128) or 8-16 (A from
// 129 to 512), the EXT instantiation or the others.  The narrow ones come
// with chunk mode (CH, nfa_block_chunk[_ext].cu) or without it
// (nfa_block[_ext].cu): chunk mode adds a branch to every step and to the
// drain, which the `seq` blocks' own instantiations leave out.  The wide
// ones (slot growth past 128 is rare) take both in one instantiation.
// Each writes the TT and warps a block it chose back into `params`.
template <bool EXT, bool CH>
static int launch_narrow(NfaParams* params, cudaStream_t stream) {
  NfaParams p = *params;
  if (!nfa_setup(p) || (p.ext != 0) != EXT || (p.chunk != 0) != CH)
    return static_cast<int>(cudaErrorInvalidValue);
  params->tt = p.tt;
  params->wpb = p.wpb;
  const int nj = (p.A + 31) / 32;
  if (nj <= 1) return launch<1, EXT, CH>(p, stream);
  if (nj <= 2) return launch<2, EXT, CH>(p, stream);
  if (nj <= 4) return launch<4, EXT, CH>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool EXT>
static int launch_wide(NfaParams* params, cudaStream_t stream) {
  NfaParams p = *params;
  if (!nfa_setup(p) || (p.ext != 0) != EXT) return static_cast<int>(cudaErrorInvalidValue);
  params->tt = p.tt;
  params->wpb = p.wpb;
  const int nj = (p.A + 31) / 32;
  if (nj <= 8) return launch<8, EXT, true>(p, stream);
  if (nj <= 16) return launch<16, EXT, true>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef NFA_F64
}  // namespace nfa_f64
#endif
