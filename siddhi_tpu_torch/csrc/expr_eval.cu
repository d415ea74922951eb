// K1 expr_eval: several programs of the predicate VM over the same rows in
// one launch -- mask programs leave bit-packed words, one 32-bit word per
// 32 rows from __ballot_sync (bit j of word w is row 32w+j,
// siddhi_tpu/core/planner.py:324-330), output programs a typed column.
// Replaces the filter/projection step (planner.py:306), the NFA pre-masks
// (nfa_device.py:1489, all of a block's nodes in one pass as there;
// nfa_parallel.py:685, per-lane parameters of the fused multi-query lanes
// included), the pattern selector/having pass (nfa_device.py:1619-1640),
// the window step's filter, arguments and selector and the join's side
// filters.  Python side: kernels/expr_eval.py.
//
// Row r reads element (r / cd) % cm of every column (cm 0: no modulo) and
// belongs to lane lane_col[r], or (r / ld) % lm; a `qparam` operand reads
// lane parameter i of the row's lane.
//
// Design.  The host decodes each program once: an instruction is a
// 16-byte record with its stack slot (a postfix program's stack depth at
// each instruction is static, core/expr.py `Program.stack_slots`) and
// its constant's 64 bits, and each launch fills in its column pointer
// and storage type or its lane parameter's row, so no row pays a table
// load.  Each block stages the records in shared memory once
// and its warps take tiles of 32 R rows (grid-stride): a thread evaluates
// R rows 32 apart, so every column read is coalesced, and each of the R
// ballots is one whole mask word.  An instruction is read and dispatched
// once for R rows; the stack is R values a slot wide and lives in
// registers for programs of depth 2 at most (the slot picked by a uniform
// branch); a deeper program runs with the stack in local memory,
// `expr_eval_kernel<0, R>`.  R is 8 where the launch has rows enough to
// fill the card at 8 a thread, else 2 (kernels/expr_eval.py
// `rows_a_thread`: below that, 8 rows a thread leave SMs idle and make
// the launch's latency longer).  A block holds as many warps as keep two
// blocks' worth of tiles on every SM.  The row map is stepped from row to
// row by additions (divisions by multiply-high only at a tile's first
// row); rows of one lane share its parameters (one load for the R rows).
// A launch whose programs only compare two operands each (`price > 100`,
// `price > __qparam0`: every pre-mask of the repo's main paths) runs on a
// kernel without the stack (`expr_eval_fused_kernel`, the host marks such
// programs fused): it pushes the two operands, casts them and compares,
// the second operand one value for the tile where it is a constant or the
// tile's one lane parameter.  (Inside the stack kernels the same path ran
// slower: their register count left fewer warps an SM.)
// Integer division and modulo, abs, sqrt, floor and ceil run through one
// out-of-line copy of the VM's operations (rare in the repo's predicates:
// the code of a copy per slot and row would be large).  Every operation is
// the VM's own (expr_vm.cuh: vm_arith, vm_cmp, vm_cast, vm_unary) with its
// operator and type fixed, so the results equal the per-row VM and the
// plain version bit for bit (--fmad=false).  Bound on the H100: bytes --
// each column read once, each output and mask word written once.
#include <atomic>

#include "expr_vm.cuh"

#define K1_THREADS 256             // at most; K1_WARPS warps a block
#define K1_WARPS (K1_THREADS / 32)
#define K1_DEEP_STACK (VM_STACK + 2)
#define K1_REG_STACK 2             // kernels/expr_eval.py REG_STACK

struct K1Ins {  // a decoded instruction; kernels/expr_eval.py INS_DTYPE
  unsigned char op, vt, vt2, slot;  // vt2: a load's storage type, a cast's source type
  int pad;
  long long arg;  // load: column pointer; qparam: its P lane values; const: its VmVal bits
};

struct K1Prog {  // one program of the launch; kernels/expr_eval.py PROG_DTYPE
  int first, len;
  int sink_vt;  // -1: mask words, else the output column's type
  int fused;    // a compare of two operands (kernels/expr_eval.py
                // `fused_compare`): 1, +2 a cast of the first, +4 of the second
  void* sink;
};

struct K1Div {  // x / d for x < 2^31: (umulhi(x, magic) + x) >> shift
  unsigned d, magic, shift, step_q;  // step_q, step_r: 32 / d and 32 % d
  unsigned step_r, pad;
};

struct ExprParams {  // layout mirrored by kernels/expr_eval.py _Params
  int n, n_ins, n_progs, tiles;
  int stage, lanes, smem, grid;  // lanes: 0 none, 1 from the map, 2 lane_col
  int wpb, esel, lsel;           // warps a block (set at launch); how the
                                 // element and the lane come (kernels/
                                 // expr_eval.py `row_fields`): 0 the row /
                                 // none, 1 r % dv, 2 r / dv, 3 their own map
  int depth, rows, pad0;         // the instantiation: stack (-1 none, 0 local
                                 // memory, K1_REG_STACK), rows a thread
  K1Div cd, cm, ld, lm, dv;      // cm.d / lm.d 0: no modulo
  const int* lane_col;
  const K1Ins* ins;
  const K1Prog* progs;
};

__device__ __forceinline__ unsigned k1_div(unsigned x, const K1Div& v) {
  return (__umulhi(x, v.magic) + x) >> v.shift;
}

// (r / d) % m, stepped 32 rows at a time: rem = r % d, x = (r / d) % m
struct K1Ctr {
  unsigned rem, x;
  __device__ __forceinline__ void init(unsigned r, const K1Div& d, const K1Div& m) {
    const unsigned q = k1_div(r, d);
    rem = r - q * d.d;
    x = m.d ? q - k1_div(q, m) * m.d : q;
  }
  __device__ __forceinline__ void step(const K1Div& d, const K1Div& m) {
    rem += d.step_r;
    unsigned inc = d.step_q;
    if (rem >= d.d) {
      rem -= d.d;
      ++inc;
    }
    x += inc;
    if (m.d && x >= m.d) {  // x grew by at most 33
      x -= m.d;
      if (x >= m.d) x %= m.d;
    }
  }
};

// the element and the lane of row r by division (a tile's first row, the
// last tile's rows)
__device__ __forceinline__ void k1_fields(const ExprParams& p, unsigned r, unsigned& elem, unsigned& lane) {
  K1Ctr a, b;
  const K1Div none{0u, 0u, 0u, 0u, 0u, 0u};
  if (p.esel == 1 || p.esel == 2 || p.lsel == 1 || p.lsel == 2) a.init(r, p.dv, none);
  elem = r;
  if (p.esel == 1) elem = a.rem;
  if (p.esel == 2) elem = a.x;
  if (p.esel == 3) {
    b.init(r, p.cd, p.cm);
    elem = b.x;
  }
  lane = 0u;
  if (p.lsel == 1) lane = a.rem;
  if (p.lsel == 2) lane = a.x;
  if (p.lsel == 3) {
    b.init(r, p.ld, p.lm);
    lane = b.x;
  }
}

template <int R>
struct K1Rows {
  unsigned elem[R];
  unsigned lane[R];
  bool same;  // every row in one lane
};

template <int R>
__device__ __forceinline__ void k1_rows(const ExprParams& p, int t, int l, bool full, K1Rows<R>& rs) {
  const unsigned r0 = static_cast<unsigned>(t) * (32 * R) + l;
  if (full) {  // one division a field at the first row, then additions
    const K1Div none{0u, 0u, 0u, 0u, 0u, 0u};
    const bool shared = p.esel == 1 || p.esel == 2 || p.lsel == 1 || p.lsel == 2;
    K1Ctr a, e, ln;
    if (shared) a.init(r0, p.dv, none);
    if (p.esel == 3) e.init(r0, p.cd, p.cm);
    if (p.lsel == 3) ln.init(r0, p.ld, p.lm);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      rs.elem[j] = p.esel == 0 ? r0 + 32u * j : p.esel == 1 ? a.rem : p.esel == 2 ? a.x : e.x;
      rs.lane[j] = p.lsel == 0 ? 0u : p.lsel == 1 ? a.rem : p.lsel == 2 ? a.x : ln.x;
      if (j + 1 < R) {
        if (shared) a.step(p.dv, none);
        if (p.esel == 3) e.step(p.cd, p.cm);
        if (p.lsel == 3) ln.step(p.ld, p.lm);
      }
    }
  } else {  // the last tile: rows past n read row n - 1's operands
#pragma unroll
    for (int j = 0; j < R; ++j)
      k1_fields(p, min(r0 + 32u * j, static_cast<unsigned>(p.n - 1)), rs.elem[j], rs.lane[j]);
  }
  if (p.lanes == 2) {
#pragma unroll
    for (int j = 0; j < R; ++j)
      rs.lane[j] = static_cast<unsigned>(
          p.lane_col[min(r0 + 32u * j, static_cast<unsigned>(p.n - 1))]);
  }
  bool same = true;
#pragma unroll
  for (int j = 1; j < R; ++j) same = same && rs.lane[j] == rs.lane[0];
  rs.same = same;
}

template <class T>
__device__ __forceinline__ const T* k1_ptr(long long a) {
  return reinterpret_cast<const T*>(a);
}

template <int R>
__device__ __forceinline__ void k1_load(const K1Ins& in, VmVal (&a)[R], const K1Rows<R>& rs) {
  const bool as_bool = in.vt == VT_BOOL;
  switch (in.vt2) {
    case VT_BOOL: {
      const unsigned char* c = k1_ptr<unsigned char>(in.arg);
#pragma unroll
      for (int j = 0; j < R; ++j) a[j] = vm_i(c[rs.elem[j]] != 0);
      break;
    }
    case VT_I32: {
      const int* c = k1_ptr<int>(in.arg);
      if (as_bool) {
#pragma unroll
        for (int j = 0; j < R; ++j) a[j] = vm_i(c[rs.elem[j]] != 0);
      } else {
#pragma unroll
        for (int j = 0; j < R; ++j) a[j] = vm_i(c[rs.elem[j]]);
      }
      break;
    }
    case VT_I64: {
      const long long* c = k1_ptr<long long>(in.arg);
      if (as_bool) {
#pragma unroll
        for (int j = 0; j < R; ++j) a[j] = vm_i(c[rs.elem[j]] != 0);
      } else {
#pragma unroll
        for (int j = 0; j < R; ++j) a[j] = vm_l(c[rs.elem[j]]);
      }
      break;
    }
    case VT_F32: {
      const float* c = k1_ptr<float>(in.arg);
      if (as_bool) {
#pragma unroll
        for (int j = 0; j < R; ++j) a[j] = vm_i(c[rs.elem[j]] != 0.0f);
      } else {
#pragma unroll
        for (int j = 0; j < R; ++j) a[j] = vm_f(c[rs.elem[j]]);
      }
      break;
    }
    default: {
      const double* c = k1_ptr<double>(in.arg);
      if (as_bool) {
#pragma unroll
        for (int j = 0; j < R; ++j) a[j] = vm_i(c[rs.elem[j]] != 0.0);
      } else {
#pragma unroll
        for (int j = 0; j < R; ++j) a[j] = vm_d(c[rs.elem[j]]);
      }
    }
  }
}

// a lane parameter: its raw bits as vm_const reads them (the low 32 bits
// for a 32-bit type), one load for rows of one lane
template <int R>
__device__ __forceinline__ void k1_qparam(const K1Ins& in, VmVal (&a)[R], const K1Rows<R>& rs) {
  const long long* c = k1_ptr<long long>(in.arg);
  const long long keep = (in.vt == VT_I64 || in.vt == VT_F64) ? -1ll : 0xffffffffll;
  if (rs.same) {
    const VmVal v = vm_l(c[rs.lane[0]] & keep);
#pragma unroll
    for (int j = 0; j < R; ++j) a[j] = v;
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) a[j] = vm_l(c[rs.lane[j]] & keep);
  }
}

template <int FROM, int TO, int R>
__device__ __forceinline__ void k1_cast_to(VmVal (&a)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) a[j] = vm_cast(a[j], FROM, TO);
}

template <int FROM, int R>
__device__ __forceinline__ void k1_cast_from(int to, VmVal (&a)[R]) {
  switch (to) {
    case VT_BOOL: k1_cast_to<FROM, VT_BOOL>(a); break;
    case VT_I32: k1_cast_to<FROM, VT_I32>(a); break;
    case VT_I64: k1_cast_to<FROM, VT_I64>(a); break;
    case VT_F32: k1_cast_to<FROM, VT_F32>(a); break;
    default: k1_cast_to<FROM, VT_F64>(a);
  }
}

template <int R>
__device__ __forceinline__ void k1_cast(int from, int to, VmVal (&a)[R]) {
  if (from == to) return;
  switch (from) {
    case VT_BOOL: k1_cast_from<VT_BOOL>(to, a); break;
    case VT_I32: k1_cast_from<VT_I32>(to, a); break;
    case VT_I64: k1_cast_from<VT_I64>(to, a); break;
    case VT_F32: k1_cast_from<VT_F32>(to, a); break;
    default: k1_cast_from<VT_F64>(to, a);
  }
}

template <int OP, int VT, int R>
__device__ __forceinline__ void k1_arith_as(VmVal (&a)[R], const VmVal (&b)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) a[j] = vm_arith(OP, VT, a[j], b[j]);
}

template <int OP, int R>
__device__ __forceinline__ void k1_arith(int vt, VmVal (&a)[R], const VmVal (&b)[R]) {
  switch (vt) {
    case VT_I32: k1_arith_as<OP, VT_I32>(a, b); break;
    case VT_I64: k1_arith_as<OP, VT_I64>(a, b); break;
    case VT_F32: k1_arith_as<OP, VT_F32>(a, b); break;
    default: k1_arith_as<OP, VT_F64>(a, b);
  }
}

template <int OP, int VT, int R>
__device__ __forceinline__ void k1_cmp_as(VmVal (&a)[R], const VmVal (&b)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) a[j] = vm_i(vm_cmp(OP, VT, a[j], b[j]));
}

template <int OP, int R>
__device__ __forceinline__ void k1_cmp(int vt, VmVal (&a)[R], const VmVal (&b)[R]) {
  switch (vt) {
    case VT_I64: k1_cmp_as<OP, VT_I64>(a, b); break;
    case VT_F32: k1_cmp_as<OP, VT_F32>(a, b); break;
    case VT_F64: k1_cmp_as<OP, VT_F64>(a, b); break;
    default: k1_cmp_as<OP, VT_I32>(a, b);  // bool and int32 (string codes)
  }
}

// integer / and %, abs, sqrt, floor, ceil: one out-of-line copy of the
// VM's operations, over a thread's rows in local memory
__device__ __noinline__ void k1_rare(int op, int vt, VmVal* a, const VmVal* b, int rows) {
  for (int j = 0; j < rows; ++j)
    a[j] = (op == OP_DIV || op == OP_MOD) ? vm_arith(op, vt, a[j], b[j]) : vm_unary(op, vt, a[j]);
}

// One instruction over a thread's R rows; a, b, c are the stack slots it
// reads from its own slot up (it writes a).
template <int R>
__device__ __forceinline__ void k1_exec(const K1Ins& in, VmVal (&a)[R], VmVal (&b)[R], VmVal (&c)[R],
                                        const K1Rows<R>& rs) {
  switch (in.op) {
    case OP_LOAD: k1_load(in, a, rs); break;
    case OP_CONST: {
      const VmVal v = vm_l(in.arg);
#pragma unroll
      for (int j = 0; j < R; ++j) a[j] = v;
      break;
    }
    case OP_QPARAM: k1_qparam(in, a, rs); break;
    case OP_CAST: k1_cast(in.vt2, in.vt, a); break;
    case OP_ADD: k1_arith<OP_ADD>(in.vt, a, b); break;
    case OP_SUB: k1_arith<OP_SUB>(in.vt, a, b); break;
    case OP_MUL: k1_arith<OP_MUL>(in.vt, a, b); break;
    case OP_MIN: k1_arith<OP_MIN>(in.vt, a, b); break;
    case OP_MAX: k1_arith<OP_MAX>(in.vt, a, b); break;
    case OP_LT: k1_cmp<OP_LT>(in.vt, a, b); break;
    case OP_LE: k1_cmp<OP_LE>(in.vt, a, b); break;
    case OP_GT: k1_cmp<OP_GT>(in.vt, a, b); break;
    case OP_GE: k1_cmp<OP_GE>(in.vt, a, b); break;
    case OP_EQ: k1_cmp<OP_EQ>(in.vt, a, b); break;
    case OP_NE: k1_cmp<OP_NE>(in.vt, a, b); break;
    case OP_AND:
#pragma unroll
      for (int j = 0; j < R; ++j) a[j] = vm_i(a[j].i & b[j].i);
      break;
    case OP_OR:
#pragma unroll
      for (int j = 0; j < R; ++j) a[j] = vm_i(a[j].i | b[j].i);
      break;
    case OP_NOT:
#pragma unroll
      for (int j = 0; j < R; ++j) a[j] = vm_i(!a[j].i);
      break;
    case OP_SELECT:
#pragma unroll
      for (int j = 0; j < R; ++j) a[j] = a[j].i ? b[j] : c[j];
      break;
    default: {
      VmVal ta[R], tb[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        ta[j] = a[j];
        tb[j] = b[j];
      }
      k1_rare(in.op, in.vt, ta, tb, R);
#pragma unroll
      for (int j = 0; j < R; ++j) a[j] = ta[j];
    }
  }
}

// A push (load, constant, lane parameter) into a.
template <int R>
__device__ __forceinline__ void k1_push(const K1Ins& in, VmVal (&a)[R], const K1Rows<R>& rs) {
  if (in.op == OP_LOAD) {
    k1_load(in, a, rs);
  } else if (in.op == OP_QPARAM) {
    k1_qparam(in, a, rs);
  } else {
    const VmVal v = vm_l(in.arg);
#pragma unroll
    for (int j = 0; j < R; ++j) a[j] = v;
  }
}

template <int OP, int VT, int R>
__device__ __forceinline__ void k1_cmp1_as(VmVal (&a)[R], VmVal b) {
#pragma unroll
  for (int j = 0; j < R; ++j) a[j] = vm_i(vm_cmp(OP, VT, a[j], b));
}

template <int OP, int R>
__device__ __forceinline__ void k1_cmp1(int vt, VmVal (&a)[R], VmVal b) {
  switch (vt) {
    case VT_I64: k1_cmp1_as<OP, VT_I64>(a, b); break;
    case VT_F32: k1_cmp1_as<OP, VT_F32>(a, b); break;
    case VT_F64: k1_cmp1_as<OP, VT_F64>(a, b); break;
    default: k1_cmp1_as<OP, VT_I32>(a, b);
  }
}

// A fused compare program -- push a [cast a] push b [cast b] compare --
// with no stack: a in registers, b one value where it is a constant or
// the tile's one lane parameter, else R values.
template <int R>
__device__ __forceinline__ void k1_fused_cmp(const K1Ins* ins, const K1Prog& pr, VmVal (&a)[R],
                                             const K1Rows<R>& rs) {
  int i = pr.first;
  k1_push(ins[i++], a, rs);
  if (pr.fused & 2) {
    const K1Ins c = ins[i++];
    k1_cast(c.vt2, c.vt, a);
  }
  const K1Ins pb = ins[i++];
  const K1Ins cb = ins[i];
  const K1Ins cmp = ins[pr.first + pr.len - 1];
  if (pb.op == OP_CONST || (pb.op == OP_QPARAM && rs.same)) {
    VmVal b = vm_l(pb.arg);
    if (pb.op == OP_QPARAM) {
      const long long keep = (pb.vt == VT_I64 || pb.vt == VT_F64) ? -1ll : 0xffffffffll;
      b = vm_l(k1_ptr<long long>(pb.arg)[rs.lane[0]] & keep);
    }
    if (pr.fused & 4) b = vm_cast(b, cb.vt2, cb.vt);
    switch (cmp.op) {
      case OP_LT: k1_cmp1<OP_LT>(cmp.vt, a, b); break;
      case OP_LE: k1_cmp1<OP_LE>(cmp.vt, a, b); break;
      case OP_GT: k1_cmp1<OP_GT>(cmp.vt, a, b); break;
      case OP_GE: k1_cmp1<OP_GE>(cmp.vt, a, b); break;
      case OP_EQ: k1_cmp1<OP_EQ>(cmp.vt, a, b); break;
      default: k1_cmp1<OP_NE>(cmp.vt, a, b);
    }
    return;
  }
  VmVal b[R];
  k1_push(pb, b, rs);
  if (pr.fused & 4) k1_cast(cb.vt2, cb.vt, b);
  switch (cmp.op) {
    case OP_LT: k1_cmp<OP_LT>(cmp.vt, a, b); break;
    case OP_LE: k1_cmp<OP_LE>(cmp.vt, a, b); break;
    case OP_GT: k1_cmp<OP_GT>(cmp.vt, a, b); break;
    case OP_GE: k1_cmp<OP_GE>(cmp.vt, a, b); break;
    case OP_EQ: k1_cmp<OP_EQ>(cmp.vt, a, b); break;
    default: k1_cmp<OP_NE>(cmp.vt, a, b);
  }
}

// the register stack: the instruction's slot by a uniform branch, every
// slot index a constant
template <int D, int R, int S = 0>
__device__ __forceinline__ void k1_at_slot(const K1Ins& in, VmVal (&st)[D][R], const K1Rows<R>& rs) {
  if constexpr (S < D) {
    if (in.slot == S) {
      k1_exec(in, st[S], st[S + 1 < D ? S + 1 : S], st[S + 2 < D ? S + 2 : S], rs);
      return;
    }
    k1_at_slot<D, R, S + 1>(in, st, rs);
  } else {
    __trap();  // a slot past the stack: the host gives this kernel only
               // programs of depth D at most (kernels/expr_eval.py depth_class)
  }
}

// a program's result (slot 0) into its mask words or its output column
template <int R>
__device__ __forceinline__ void k1_sink(const K1Prog& pr, const VmVal (&v)[R], int n, int t, int l, bool full) {
  const unsigned r0 = static_cast<unsigned>(t) * (32 * R) + l;
  if (pr.sink_vt < 0) {
    unsigned mine = 0u;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool bit = (full || r0 + 32u * j < static_cast<unsigned>(n)) && v[j].i != 0;
      const unsigned w = __ballot_sync(0xffffffffu, bit);
      if (l == j) mine = w;
    }
    const unsigned wi = static_cast<unsigned>(t) * R + l;
    if (l < R && wi < (static_cast<unsigned>(n) + 31u) / 32u) static_cast<unsigned*>(pr.sink)[wi] = mine;
    return;
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const unsigned r = r0 + 32u * j;
    if (full || r < static_cast<unsigned>(n)) vm_write(pr.sink, pr.sink_vt, r, v[j]);
  }
}

// D: the register stack's depth (K1_REG_STACK), 0: the stack in local memory,
// -1: no stack (every program of the launch a fused compare);
// R: rows a thread (8, or 2 for a launch of few rows)
template <int D, int R>
__device__ __forceinline__ void k1_body(const ExprParams& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const K1Ins* ins = p.ins;
  const K1Prog* progs = p.progs;
  if (p.stage) {
    long long* dst = reinterpret_cast<long long*>(smem);
    const long long* src_i = reinterpret_cast<const long long*>(p.ins);
    const long long* src_p = reinterpret_cast<const long long*>(p.progs);
    const int wi = 2 * p.n_ins, wp = 3 * p.n_progs;  // 8-byte words
    for (int k = threadIdx.x; k < wi + wp; k += blockDim.x) dst[k] = k < wi ? src_i[k] : src_p[k - wi];
    __syncthreads();
    ins = reinterpret_cast<const K1Ins*>(smem);
    progs = reinterpret_cast<const K1Prog*>(smem + 16 * p.n_ins);
  }
  const int l = threadIdx.x & 31;
  const int wpb = blockDim.x >> 5;
  const int nw = gridDim.x * wpb;
  using Stack = VmVal[D > 0 ? D : K1_DEEP_STACK][R];
  [[maybe_unused]] Stack st;
  for (int t = blockIdx.x * wpb + (threadIdx.x >> 5); t < p.tiles; t += nw) {
    const bool full = static_cast<long long>(t + 1) * (32 * R) <= p.n;
    K1Rows<R> rs;
    k1_rows(p, t, l, full, rs);
    for (int q = 0; q < p.n_progs; ++q) {
      const K1Prog pr = progs[q];
      if constexpr (D < 0) {  // every program a fused compare
        VmVal v[R];
        k1_fused_cmp(ins, pr, v, rs);
        k1_sink(pr, v, p.n, t, l, full);
      } else {
        for (int i = pr.first; i < pr.first + pr.len; ++i) {
          const K1Ins in = ins[i];
          if constexpr (D > 0) {
            k1_at_slot<D>(in, st, rs);
          } else {
            k1_exec(in, st[in.slot], st[in.slot + 1], st[in.slot + 2], rs);
          }
        }
        k1_sink(pr, st[0], p.n, t, l, full);
      }
    }
  }
}

template <int D, int R>
__global__ void __launch_bounds__(K1_THREADS) expr_eval_kernel(const __grid_constant__ ExprParams p) {
  k1_body<D, R>(p);
}

// every program a fused compare: no stack, and registers for three blocks
// an SM (faster on the card than two at C5's pre-mask, a few spilled
// bytes included)
template <int R>
__global__ void __launch_bounds__(K1_THREADS, 3) expr_eval_fused_kernel(const __grid_constant__ ExprParams p) {
  k1_body<-1, R>(p);
}

// Blocks of `wpb` warps an SM of instantiation <D, R> staging `smem`
// bytes: the occupancy calculator's answer for that many warps and the
// next power of two of at least 1 KB of shared memory (no fewer blocks
// than the launch fits), asked once per (warps, size) and kept, so a
// launch makes no other call than the kernel's.
template <int D, int R>
static cudaError_t k1_per_sm(int wpb, size_t smem, int& per_sm) {
  static std::atomic<int> known[K1_WARPS + 1][7];  // up to 32 KB staged
  int bucket = 0;
  size_t cap = 0;
  if (smem) {
    for (bucket = 1, cap = 1024; cap < smem && bucket < 6; cap <<= 1) ++bucket;
    if (cap < smem) cap = smem;
  }
  int v = known[wpb][bucket].load(std::memory_order_relaxed);
  if (v == 0) {
    cudaError_t err;
    if constexpr (D < 0)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&v, expr_eval_fused_kernel<R>, 32 * wpb, cap);
    else
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&v, expr_eval_kernel<D, R>, 32 * wpb, cap);
    if (err != cudaSuccess) return err;
    v = v > 0 ? v : 1;
    known[wpb][bucket].store(v, std::memory_order_relaxed);
  }
  per_sm = v;
  return cudaSuccess;
}

// The launch of instantiation <D, R>: as many blocks as the card holds
// at once, at most enough for every tile (grid-stride, so each block
// stages the records once).
template <int D, int R>
static cudaError_t k1_launch_as(ExprParams& p, int sms, size_t smem, cudaStream_t stream) {
  int per_sm = 0;
  const cudaError_t err = k1_per_sm<D, R>(p.wpb, smem, per_sm);
  if (err != cudaSuccess) return err;
  const int need = (p.tiles + p.wpb - 1) / p.wpb;
  const int room = per_sm * sms;
  p.grid = need < room ? need : room;
  if constexpr (D < 0)
    expr_eval_fused_kernel<R><<<static_cast<unsigned>(p.grid), 32u * p.wpb, smem, stream>>>(p);
  else
    expr_eval_kernel<D, R><<<static_cast<unsigned>(p.grid), 32u * p.wpb, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
static cudaError_t k1_launch(ExprParams& p, int rows, int sms, size_t smem, cudaStream_t stream) {
  return rows == 8 ? k1_launch_as<D, 8>(p, sms, smem, stream) : k1_launch_as<D, 2>(p, sms, smem, stream);
}

extern "C" int expr_eval_launch(ExprParams* params, cudaStream_t stream) {
  ExprParams& p = *params;
  const int depth = p.depth, rows = p.rows;
  if (p.n <= 0 || p.n_progs < 1 || !(depth == -1 || depth == 0 || depth == K1_REG_STACK) ||
      !(rows == 8 || rows == 2) ||
      p.tiles != (static_cast<long long>(p.n) + 32 * rows - 1) / (32 * rows))
    return static_cast<int>(cudaErrorInvalidValue);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // warps a block: as many as keep two blocks' worth of tiles on every
  // SM, so a launch of few tiles still spreads over the card
  int wpb = (p.tiles + 2 * sms - 1) / (2 * sms);
  p.wpb = wpb < 1 ? 1 : (wpb > K1_WARPS ? K1_WARPS : wpb);
  const size_t smem = p.stage ? static_cast<size_t>(p.smem) : 0;
  cudaError_t err;
  if (depth == -1)
    err = k1_launch<-1>(p, rows, sms, smem, stream);
  else if (depth == K1_REG_STACK)
    err = k1_launch<K1_REG_STACK>(p, rows, sms, smem, stream);
  else
    err = k1_launch<0>(p, rows, sms, smem, stream);
  return static_cast<int>(err);
}
