// K2 nfa_block: the sequential batched NFA over one (T, P) event block.
//
// Replaces the jitted _block_impl of siddhi_tpu/core/nfa_device.py (:1486,
// :1560): lax.scan over T of _step (:726) with _alloc_head (:1328) and the
// E-lane drain _drain_done (:1428), then ceil(A/E) drain rounds (:1581),
// and the earliest live deadline (:1649).
// One warp per partition lane, one thread per slot (thread `lane` owns
// slots lane, lane+32, ... when A > 32).  Slot stations live in registers,
// capture and deadline rows in shared memory ([K][A] per warp); every
// thread reads and writes only its own slots, so the two-phase commit of
// _step (stations tested against the pre-event occ, at most one advance per
// event) holds without synchronisation.  Per event, in the reference order:
//   0. absent deadlines at or before the event's timestamp fire first when
//      deadlines may fire on this cell (dl_fire: timer ticks, and events
//      under playback): the slot advances (a chain of absent positions can
//      cascade) or, at the last position, completes with the deadline as
//      its timestamp; the fired row is disarmed;
//   1. lazy, strict `within` expiry (age > within on events and ticks),
//      then station matches (stream, pre-mask bit, capture-dependent
//      conjuncts through the VM); a match at an absent station kills the
//      slot (and disarms its deadlines), at a stream station it writes the
//      captures, parks a completion or advances, arming the deadline of an
//      absent position it enters; sequence strictness;
//   2. the drain: parked slots ranked by slot index (ballot + popc), the
//      first E emit and free;
//   3. the head: the lowest free slot (ballot + ffs) takes a new partial
//      match (its deadlines disarmed, the next position's armed), or the
//      lane counts a dropped head (of_slots).
// Matches append to the (rows, M) output through one atomicAdd per warp
// per drain; rows past M are counted but not written (the plan retries
// with a bigger M from the untouched input state).  Fused multi-query
// lanes (bcast) read the broadcast (T, 1) event grids at row t, their
// (T, P) pre-masks at (t, lane), `qparam` operands at the warp's lane, and
// emit the lane as the match's __qid__.  Per-position tables, column
// pointers and programs come in a device table; each block stages the
// programs in shared memory ahead of the warps' capture rows.
#include "expr_vm.cuh"

#define NO_FIRST (1 << 30)
#define NO_DEADLINE 0x7fffffff
#define FULL 0xffffffffu

struct NfaParams {  // layout mirrored by kernels/nfa_block.py _Params
  int T, P, A, S, E, is_seq, every_head, multi, Kf, Ki, Kl, Ka, C, M, ts_slot, wpb;
  int bcast, playback, emit_qid, comp_ts_row, comp_seq_row, n_words, n_consts, stage;
  int prog_bytes, pad0;
  const int* ts;
  const int* seq;
  const unsigned char* valid;
  const unsigned char* tick;
  const int* scode;
  const long long* qparams;
  const void* const* ev;
  const int* ev_vt;
  const int* pos_scode;
  const int* pos_within;
  const int* pos_kind;     // 0 stream, 1 absent
  const int* pos_dl_row;   // deadline row of an absent position, -1 none
  const int* pos_waiting;
  const unsigned* const* pre;
  const int* prog_off;
  const int* prog_len;
  const int* cw_off;
  const int* cw_len;
  const int* cw_group;
  const int* cw_row;
  const int* cw_src;
  const int* occ_in;
  const int* first_in;
  const int* hseq_in;
  const float* capf_in;
  const int* capi_in;
  const long long* capl_in;
  const int* dl_in;
  const unsigned char* armed_in;
  const int* ofs_in;
  int* occ_out;
  int* first_out;
  int* hseq_out;
  float* capf_out;
  int* capi_out;
  long long* capl_out;
  int* dl_out;
  unsigned char* armed_out;
  int* ofs_out;
  int* out_i;
  float* out_f;
  long long* out_l;
  int* meta;
  const long long* consts;
  const int* words;
};

struct Caps {  // one warp's capture and deadline rows in shared memory, [K][A]
  float* f;
  int* i;
  long long* l;
  int* d;
};

// VM environment of one slot at one event: grid columns at the event,
// then the slot's capture rows, then the event's ts offset; lane
// parameters at the warp's partition lane.
struct SlotEnv {
  const NfaParams& p;
  long long idx;
  int a;
  int part;
  Caps c;
  int ts;
  __device__ VmVal load(int slot, int vt) {
    if (slot < p.C) {
      const int have = p.ev_vt[slot];
      return vm_as(vm_read(p.ev[slot], have, idx), have, vt);
    }
    slot -= p.C;
    if (slot < p.Kf) return vm_f(c.f[slot * p.A + a]);
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

__device__ __forceinline__ bool pre_bit(const unsigned* w, long long idx) {
  return w == nullptr || ((w[idx >> 5] >> (idx & 31)) & 1u);
}

__device__ __forceinline__ VmVal src_value(const NfaParams& p, int src, long long idx,
                                           int ts, int seq, int& vt) {
  if (src == -1) { vt = VT_I32; return vm_i(ts); }
  if (src == -2) { vt = VT_I32; return vm_i(seq); }
  vt = p.ev_vt[src];
  return vm_read(p.ev[src], vt, idx);
}

// Capture the event into slot a for position pi (the position's table of
// (group, row, source) writes: ref.attr, ref[last].attr, completion ts/seq).
__device__ void cap_write(const NfaParams& p, int pi, long long idx, int ts, int seq,
                          int a, Caps c) {
  const int end = p.cw_off[pi] + p.cw_len[pi];
  for (int w = p.cw_off[pi]; w < end; ++w) {
    int vt;
    const VmVal v = src_value(p, p.cw_src[w], idx, ts, seq, vt);
    const int r = p.cw_row[w];
    if (p.cw_group[w] == 0) c.f[r * p.A + a] = vm_cast(v, vt, VT_F32).f;
    else if (p.cw_group[w] == 1) c.i[r * p.A + a] = vm_cast(v, vt, VT_I32).i;
    else c.l[r * p.A + a] = vm_cast(v, vt, VT_I64).l;
  }
}

// A slot entering position pi: an absent position arms its deadline one
// waiting period after `at` (_enter_position).
__device__ __forceinline__ void enter(const NfaParams& p, int pi, int a, int at, Caps c) {
  const int r = p.pos_dl_row[pi];
  if (r >= 0)
    c.d[r * p.A + a] = static_cast<int>(static_cast<unsigned>(at) +
                                        static_cast<unsigned>(p.pos_waiting[pi]));
}

__device__ __forceinline__ void disarm(const NfaParams& p, int a, Caps c) {
  for (int r = 0; r < p.Ka; ++r) c.d[r * p.A + a] = NO_DEADLINE;
}

// Emit slot a's parked snapshot as match row `pos`.
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
__device__ void emit_single(const NfaParams& p, long long idx, int ts, int seq, int part) {
  const int pos = atomicAdd(p.meta, 1);
  if (pos >= p.M) return;
  const long long M = p.M;
  for (int w = p.cw_off[0]; w < p.cw_off[0] + p.cw_len[0]; ++w) {
    int vt;
    const VmVal v = src_value(p, p.cw_src[w], idx, ts, seq, vt);
    const int r = p.cw_row[w];
    if (p.cw_group[w] == 0) p.out_f[r * M + pos] = vm_cast(v, vt, VT_F32).f;
    else if (p.cw_group[w] == 1) p.out_i[r * M + pos] = vm_cast(v, vt, VT_I32).i;
    else p.out_l[r * M + pos] = vm_cast(v, vt, VT_I64).l;
  }
  int r = p.Ki;
  p.out_i[r++ * M + pos] = seq;              // __head_seq__
  if (p.emit_qid) p.out_i[r++ * M + pos] = part;  // __qid__
  p.out_i[r++ * M + pos] = ts;               // __comp_ts__
  p.out_i[r * M + pos] = seq;                // __comp_seq__
}

// Drain lane: the first E parked slots (by slot index) emit and free.
template <int NJ>
__device__ void drain(const NfaParams& p, int lane, int part, int (&occ)[NJ],
                      const int (&hsq)[NJ], Caps c) {
  const int PARK = p.S + 1;
  unsigned pb[NJ];
  int tot = 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    pb[j] = __ballot_sync(FULL, occ[j] == PARK);
    tot += __popc(pb[j]);
  }
  if (tot == 0) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(p.meta, tot < p.E ? tot : p.E);
  base = __shfl_sync(FULL, base, 0);
  int before = 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (occ[j] == PARK) {
      const int rank = before + __popc(pb[j] & ((1u << lane) - 1u));
      if (rank < p.E) {
        emit_slot(p, base + rank, lane + 32 * j, hsq[j], part, c);
        occ[j] = 0;
      }
    }
    before += __popc(pb[j]);
  }
}

template <int NJ>
__global__ void nfa_block_kernel(const __grid_constant__ NfaParams p) {
  extern __shared__ long long smem[];
  const int* words = p.words;
  const long long* consts = p.consts;
  if (p.stage) vm_stage(p.words, p.n_words, p.consts, p.n_consts, smem, &words, &consts);
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int part = blockIdx.x * p.wpb + wib;
  if (part >= p.P) return;               // whole warp leaves together
  const int A = p.A, P = p.P, S = p.S, PARK = S + 1;
  const size_t per_warp = static_cast<size_t>(p.Kl) * A +
                          (static_cast<size_t>(p.Kf + p.Ki + p.Ka) * A + 1) / 2;  // 8-byte units
  Caps c;
  c.l = smem + p.prog_bytes / 8 + wib * per_warp;
  c.f = reinterpret_cast<float*>(c.l + static_cast<size_t>(p.Kl) * A);
  c.i = reinterpret_cast<int*>(c.f + static_cast<size_t>(p.Kf) * A);
  c.d = c.i + static_cast<size_t>(p.Ki) * A;

  int occ[NJ], fts[NJ], hsq[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int a = lane + 32 * j;
    occ[j] = -1;                         // not a slot: never free, never parked
    fts[j] = 0;
    hsq[j] = 0;
    if (a < A) {
      const long long g = static_cast<long long>(a) * P + part;
      occ[j] = p.occ_in[g];
      fts[j] = p.first_in[g];
      hsq[j] = p.hseq_in[g];
      for (int k = 0; k < p.Kf; ++k) c.f[k * A + a] = p.capf_in[(static_cast<long long>(k) * A + a) * P + part];
      for (int k = 0; k < p.Ki; ++k) c.i[k * A + a] = p.capi_in[(static_cast<long long>(k) * A + a) * P + part];
      for (int k = 0; k < p.Kl; ++k) c.l[k * A + a] = p.capl_in[(static_cast<long long>(k) * A + a) * P + part];
      for (int k = 0; k < p.Ka; ++k) c.d[k * A + a] = p.dl_in[(static_cast<long long>(k) * A + a) * P + part];
    }
  }
  bool armed = p.armed_in[part] != 0;
  int ofs = p.ofs_in[part];

  for (int t = 0; t < p.T; ++t) {
    const long long eidx = p.bcast ? static_cast<long long>(t)
                                   : static_cast<long long>(t) * P + part;
    const long long pidx = static_cast<long long>(t) * P + part;
    const int ts = p.ts[eidx];
    const int seq = p.seq[eidx];
    const bool valid = p.valid[eidx] != 0;
    const bool tick = p.tick != nullptr && p.tick[eidx] != 0;
    const bool timey = valid || tick;
    const bool dl_fire = p.playback ? timey : tick;
    const int sc = p.multi ? p.scode[eidx] : 0;

    // 0-1. deadlines, expiry, stations
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      int o0 = occ[j];
      if (o0 < 1 || o0 > S) continue;
      const int a = lane + 32 * j;
      bool fired = false;                // the last (absent) position completed
      int fired_at = 0;
      if (dl_fire && p.Ka > 0) {
        while (true) {
          const int pi = o0 - 1;
          const int r = p.pos_dl_row[pi];
          if (p.pos_kind[pi] != 1 || r < 0) break;
          const int d = c.d[r * A + a];
          if (d > ts) break;              // NO_DEADLINE never fires
          c.d[r * A + a] = NO_DEADLINE;
          if (pi == S - 1) {
            fired = true;
            fired_at = d;
            break;
          }
          o0 = pi + 2;
          enter(p, pi + 1, a, d, c);
        }
      }
      const int pi = o0 - 1;
      const int w = p.pos_within[pi];
      const int age = static_cast<int>(static_cast<unsigned>(ts) - static_cast<unsigned>(fts[j]));
      if (w >= 0 && timey && age > w) {  // expired: the slot dies
        occ[j] = 0;
        disarm(p, a, c);
        continue;
      }
      bool trans = false;
      int no = o0;
      if (pi >= 1 && valid && (!p.multi || sc == p.pos_scode[pi]) && pre_bit(p.pre[pi], pidx)) {
        bool m = true;
        if (p.prog_len[pi] > 0) {
          SlotEnv env{p, eidx, a, part, c, ts};
          m = vm_run(words + p.prog_off[pi], p.prog_len[pi], consts, env).i != 0;
        }
        if (m && p.pos_kind[pi] == 1) {  // a forbidden arrival: the slot dies
          occ[j] = 0;
          disarm(p, a, c);
          continue;
        }
        if (m) {
          trans = true;
          cap_write(p, pi, eidx, ts, seq, a, c);
          no = pi == S - 1 ? PARK : pi + 2;
          if (pi < S - 1) enter(p, pi + 1, a, ts, c);
        }
      }
      if (fired) {
        c.i[p.comp_ts_row * A + a] = fired_at;
        c.i[p.comp_seq_row * A + a] = seq;
        no = PARK;
      }
      if (p.is_seq && no > 0 && no < PARK && fts[j] != NO_FIRST && !trans && valid) no = 0;
      occ[j] = no;
    }

    // 2. drain lane
    if (S > 1) drain<NJ>(p, lane, part, occ, hsq, c);

    // 3. head
    const bool ok0 = armed && valid && (!p.multi || sc == p.pos_scode[0]) && pre_bit(p.pre[0], pidx);
    if (!ok0) continue;
    if (!p.every_head) armed = false;
    if (S == 1) {
      if (lane == 0) emit_single(p, eidx, ts, seq, part);
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
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (hot == lane + 32 * j) {
        occ[j] = 2;                      // stationed at position 1
        fts[j] = ts;
        hsq[j] = seq;
        disarm(p, hot, c);
        cap_write(p, 0, eidx, ts, seq, hot, c);
        enter(p, 1, hot, ts, c);
      }
    }
  }
  if (S > 1) {
    const int rounds = (A + p.E - 1) / p.E;
    for (int r = 0; r < rounds; ++r) drain<NJ>(p, lane, part, occ, hsq, c);
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
    p.ofs_out[part] = ofs;
    atomicAdd(p.meta + 1, ofs);
    if (min_dl != NO_DEADLINE) atomicMin(p.meta + 2, min_dl);
  }
}

template <int NJ>
static int launch(NfaParams& p, size_t per_warp, cudaStream_t stream) {
  const size_t smem = p.prog_bytes + per_warp * 8 * p.wpb;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(nfa_block_kernel<NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (p.P + p.wpb - 1) / p.wpb;
  nfa_block_kernel<NJ><<<blocks, 32 * p.wpb, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nfa_block_launch(const NfaParams* params, cudaStream_t stream) {
  NfaParams p = *params;
  p.prog_bytes = (p.prog_bytes + 7) / 8 * 8;
  const size_t per_warp = static_cast<size_t>(p.Kl) * p.A +
                          (static_cast<size_t>(p.Kf + p.Ki + p.Ka) * p.A + 1) / 2;  // 8-byte units
  int wpb = 4;
  while (wpb > 1 && p.prog_bytes + per_warp * 8 * wpb > 96 * 1024) wpb >>= 1;
  if (p.prog_bytes + per_warp * 8 > 200 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  p.wpb = wpb;
  const int nj = (p.A + 31) / 32;
  if (nj <= 1) return launch<1>(p, per_warp, stream);
  if (nj <= 2) return launch<2>(p, per_warp, stream);
  if (nj <= 4) return launch<4>(p, per_warp, stream);
  if (nj <= 8) return launch<8>(p, per_warp, stream);
  if (nj <= 16) return launch<16>(p, per_warp, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
