// Predicate VM shared by the port's CUDA kernels (expr_eval.cu, nfa_block.cu).
//
// A program is a postfix sequence of (opcode word, operand word) int32
// pairs emitted by siddhi_tpu_torch/core/expr.py `emit_program`:
//   opcode word = op | vt << 8 | vt2 << 12
// with vt the value type of the operation (for compares: of the operands)
// and vt2 the source type of a cast.  Constants live in a pool of 64-bit
// raw values.  A `qparam` operand reads lane parameter i of the row's lane
// (a fused multi-query plan's lifted constant, raw 64-bit bits like a
// pool entry): `env.param(i, vt)`, each kernel's environment knowing its
// lane.  One thread runs one program over one row: its own column
// values, or for the NFA its own slot's captures.  Semantics match the
// plain torch back end bit for bit: Java numeric promotion is explicit in
// the program (casts), integer / and % truncate with the XLA corner cases
// (x/0 = -1, x%0 = x, MIN/-1 = MIN, MIN%-1 = 0), integer arithmetic wraps,
// float -> int casts saturate with NaN -> 0, min/max propagate NaN.  The
// library is built with --fmad=false so no a*b+c contracts into an FMA.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define VM_STACK 16

enum VmType { VT_BOOL = 0, VT_I32 = 1, VT_I64 = 2, VT_F32 = 3, VT_F64 = 4 };

enum VmOp {
  OP_LOAD = 1, OP_CONST = 2, OP_CAST = 3, OP_ADD = 4, OP_SUB = 5,
  OP_MUL = 6, OP_DIV = 7, OP_MOD = 8, OP_LT = 9, OP_LE = 10, OP_GT = 11,
  OP_GE = 12, OP_EQ = 13, OP_NE = 14, OP_AND = 15, OP_OR = 16, OP_NOT = 17,
  OP_SELECT = 18, OP_MIN = 19, OP_MAX = 20, OP_ABS = 21, OP_SQRT = 22,
  OP_FLOOR = 23, OP_CEIL = 24, OP_QPARAM = 25
};

union VmVal {
  double d;
  long long l;
  float f;
  int i;
};

__device__ __forceinline__ VmVal vm_i(int x) { VmVal v; v.l = 0; v.i = x; return v; }
__device__ __forceinline__ VmVal vm_l(long long x) { VmVal v; v.l = x; return v; }
__device__ __forceinline__ VmVal vm_f(float x) { VmVal v; v.l = 0; v.f = x; return v; }
__device__ __forceinline__ VmVal vm_d(double x) { VmVal v; v.d = x; return v; }

// Read one element of a typed column (storage type `vt`: bool = 1 byte).
__device__ __forceinline__ VmVal vm_read(const void* base, int vt, long long i) {
  switch (vt) {
    case VT_BOOL: return vm_i(static_cast<const unsigned char*>(base)[i] != 0);
    case VT_I32: return vm_i(static_cast<const int*>(base)[i]);
    case VT_I64: return vm_l(static_cast<const long long*>(base)[i]);
    case VT_F32: return vm_f(static_cast<const float*>(base)[i]);
    default: return vm_d(static_cast<const double*>(base)[i]);
  }
}

// A load of a column stored as `have` into a value of type `want`: equal
// types, or a bool view of an integer capture row (x != 0).
__device__ __forceinline__ VmVal vm_as(VmVal v, int have, int want) {
  if (want == VT_BOOL && have != VT_BOOL) {
    switch (have) {
      case VT_I64: return vm_i(v.l != 0);
      case VT_F32: return vm_i(v.f != 0.0f);
      case VT_F64: return vm_i(v.d != 0.0);
      default: return vm_i(v.i != 0);
    }
  }
  return v;
}

__device__ __forceinline__ void vm_write(void* base, int vt, long long i, VmVal v) {
  switch (vt) {
    case VT_BOOL: static_cast<unsigned char*>(base)[i] = v.i != 0; break;
    case VT_I32: static_cast<int*>(base)[i] = v.i; break;
    case VT_I64: static_cast<long long*>(base)[i] = v.l; break;
    case VT_F32: static_cast<float*>(base)[i] = v.f; break;
    default: static_cast<double*>(base)[i] = v.d; break;
  }
}

__device__ __forceinline__ VmVal vm_const(long long bits, int vt) {
  switch (vt) {
    case VT_F64: return vm_d(__longlong_as_double(bits));
    case VT_F32: return vm_f(__int_as_float(static_cast<int>(bits)));
    case VT_I64: return vm_l(bits);
    default: return vm_i(static_cast<int>(bits));
  }
}

__device__ __forceinline__ VmVal vm_cast(VmVal v, int from, int to) {
  if (from == to) return v;
  switch (to) {
    case VT_BOOL:
      return vm_as(v, from, VT_BOOL);
    case VT_I32:
      switch (from) {
        case VT_I64: return vm_i(static_cast<int>(static_cast<unsigned long long>(v.l)));
        case VT_F32: return vm_i(__float2int_rz(v.f));
        case VT_F64: return vm_i(__double2int_rz(v.d));
        default: return vm_i(v.i);
      }
    case VT_I64:
      switch (from) {
        case VT_F32: return vm_l(__float2ll_rz(v.f));
        case VT_F64: return vm_l(__double2ll_rz(v.d));
        default: return vm_l(static_cast<long long>(v.i));
      }
    case VT_F32:
      switch (from) {
        case VT_I64: return vm_f(__ll2float_rn(v.l));
        case VT_F64: return vm_f(__double2float_rn(v.d));
        default: return vm_f(__int2float_rn(v.i));
      }
    default:
      switch (from) {
        case VT_I64: return vm_d(__ll2double_rn(v.l));
        case VT_F32: return vm_d(static_cast<double>(v.f));
        default: return vm_d(static_cast<double>(v.i));
      }
  }
}

__device__ __forceinline__ VmVal vm_arith(int op, int vt, VmVal a, VmVal b) {
  switch (vt) {
    case VT_I32: {
      unsigned ua = static_cast<unsigned>(a.i), ub = static_cast<unsigned>(b.i);
      switch (op) {
        case OP_ADD: return vm_i(static_cast<int>(ua + ub));
        case OP_SUB: return vm_i(static_cast<int>(ua - ub));
        case OP_MUL: return vm_i(static_cast<int>(ua * ub));
        case OP_DIV:
          if (b.i == 0) return vm_i(-1);
          if (b.i == -1) return vm_i(static_cast<int>(0u - ua));
          return vm_i(a.i / b.i);
        case OP_MOD:
          if (b.i == 0) return a;
          if (b.i == -1) return vm_i(0);
          return vm_i(a.i % b.i);
        case OP_MIN: return vm_i(a.i < b.i ? a.i : b.i);
        default: return vm_i(a.i > b.i ? a.i : b.i);
      }
    }
    case VT_I64: {
      unsigned long long ua = static_cast<unsigned long long>(a.l);
      unsigned long long ub = static_cast<unsigned long long>(b.l);
      switch (op) {
        case OP_ADD: return vm_l(static_cast<long long>(ua + ub));
        case OP_SUB: return vm_l(static_cast<long long>(ua - ub));
        case OP_MUL: return vm_l(static_cast<long long>(ua * ub));
        case OP_DIV:
          if (b.l == 0) return vm_l(-1);
          if (b.l == -1) return vm_l(static_cast<long long>(0ull - ua));
          return vm_l(a.l / b.l);
        case OP_MOD:
          if (b.l == 0) return a;
          if (b.l == -1) return vm_l(0);
          return vm_l(a.l % b.l);
        case OP_MIN: return vm_l(a.l < b.l ? a.l : b.l);
        default: return vm_l(a.l > b.l ? a.l : b.l);
      }
    }
    case VT_F32:
      switch (op) {
        case OP_ADD: return vm_f(__fadd_rn(a.f, b.f));
        case OP_SUB: return vm_f(__fsub_rn(a.f, b.f));
        case OP_MUL: return vm_f(__fmul_rn(a.f, b.f));
        case OP_DIV: return vm_f(__fdiv_rn(a.f, b.f));
        case OP_MOD: return vm_f(fmodf(a.f, b.f));
        case OP_MIN:
          if (a.f != a.f || b.f != b.f) return vm_f(__int_as_float(0x7fc00000));
          return vm_f(a.f < b.f ? a.f : b.f);
        default:
          if (a.f != a.f || b.f != b.f) return vm_f(__int_as_float(0x7fc00000));
          return vm_f(a.f > b.f ? a.f : b.f);
      }
    default:
      switch (op) {
        case OP_ADD: return vm_d(__dadd_rn(a.d, b.d));
        case OP_SUB: return vm_d(__dsub_rn(a.d, b.d));
        case OP_MUL: return vm_d(__dmul_rn(a.d, b.d));
        case OP_DIV: return vm_d(__ddiv_rn(a.d, b.d));
        case OP_MOD: return vm_d(fmod(a.d, b.d));
        case OP_MIN:
          if (a.d != a.d || b.d != b.d) return vm_d(__longlong_as_double(0x7ff8000000000000ll));
          return vm_d(a.d < b.d ? a.d : b.d);
        default:
          if (a.d != a.d || b.d != b.d) return vm_d(__longlong_as_double(0x7ff8000000000000ll));
          return vm_d(a.d > b.d ? a.d : b.d);
      }
  }
}

__device__ __forceinline__ bool vm_cmp(int op, int vt, VmVal a, VmVal b) {
  switch (vt) {
    case VT_I64:
      switch (op) {
        case OP_LT: return a.l < b.l; case OP_LE: return a.l <= b.l;
        case OP_GT: return a.l > b.l; case OP_GE: return a.l >= b.l;
        case OP_EQ: return a.l == b.l; default: return a.l != b.l;
      }
    case VT_F32:
      switch (op) {
        case OP_LT: return a.f < b.f; case OP_LE: return a.f <= b.f;
        case OP_GT: return a.f > b.f; case OP_GE: return a.f >= b.f;
        case OP_EQ: return a.f == b.f; default: return a.f != b.f;
      }
    case VT_F64:
      switch (op) {
        case OP_LT: return a.d < b.d; case OP_LE: return a.d <= b.d;
        case OP_GT: return a.d > b.d; case OP_GE: return a.d >= b.d;
        case OP_EQ: return a.d == b.d; default: return a.d != b.d;
      }
    default:  // bool and int32 (string codes included)
      switch (op) {
        case OP_LT: return a.i < b.i; case OP_LE: return a.i <= b.i;
        case OP_GT: return a.i > b.i; case OP_GE: return a.i >= b.i;
        case OP_EQ: return a.i == b.i; default: return a.i != b.i;
      }
  }
}

__device__ __forceinline__ VmVal vm_unary(int op, int vt, VmVal a) {
  switch (op) {
    case OP_NOT: return vm_i(!a.i);
    case OP_ABS:
      switch (vt) {
        case VT_I32: return vm_i(a.i < 0 ? static_cast<int>(0u - static_cast<unsigned>(a.i)) : a.i);
        case VT_I64: return vm_l(a.l < 0 ? static_cast<long long>(0ull - static_cast<unsigned long long>(a.l)) : a.l);
        case VT_F32: return vm_f(fabsf(a.f));
        default: return vm_d(fabs(a.d));
      }
    case OP_SQRT: return vt == VT_F32 ? vm_f(__fsqrt_rn(a.f)) : vm_d(__dsqrt_rn(a.d));
    case OP_FLOOR: return vt == VT_F32 ? vm_f(floorf(a.f)) : vm_d(floor(a.d));
    default: return vt == VT_F32 ? vm_f(ceilf(a.f)) : vm_d(ceil(a.d));
  }
}

// Copy a program set (words, then the constant pool) into shared memory,
// all threads of the block together; returns the staged pointers.  `sm`
// is 8-byte aligned and holds 8 * n_consts + 4 * n_words bytes.
__device__ __forceinline__ void vm_stage(const int* words, int n_words, const long long* consts,
                                         int n_consts, long long* sm, const int** w_out,
                                         const long long** c_out) {
  for (int i = threadIdx.x; i < n_consts; i += blockDim.x) sm[i] = consts[i];
  int* sw = reinterpret_cast<int*>(sm + n_consts);
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) sw[i] = words[i];
  __syncthreads();
  *w_out = sw;
  *c_out = sm;
}

// Run one program; `env.load(slot, vt)` supplies column/capture values,
// `env.param(i, vt)` the row's lane parameters.
template <class Env>
__device__ VmVal vm_run(const int* words, int len, const long long* consts, Env& env) {
  VmVal st[VM_STACK];
  int sp = 0;
  for (int i = 0; i < len; i += 2) {
    const int w = words[i];
    const int arg = words[i + 1];
    const int op = w & 0xFF, vt = (w >> 8) & 0xF, vt2 = (w >> 12) & 0xF;
    switch (op) {
      case OP_LOAD: st[sp++] = env.load(arg, vt); break;
      case OP_CONST: st[sp++] = vm_const(consts[arg], vt); break;
      case OP_QPARAM: st[sp++] = env.param(arg, vt); break;
      case OP_CAST: st[sp - 1] = vm_cast(st[sp - 1], vt2, vt); break;
      case OP_ADD: case OP_SUB: case OP_MUL: case OP_DIV: case OP_MOD:
      case OP_MIN: case OP_MAX:
        --sp;
        st[sp - 1] = vm_arith(op, vt, st[sp - 1], st[sp]);
        break;
      case OP_LT: case OP_LE: case OP_GT: case OP_GE: case OP_EQ: case OP_NE:
        --sp;
        st[sp - 1] = vm_i(vm_cmp(op, vt, st[sp - 1], st[sp]));
        break;
      case OP_AND: --sp; st[sp - 1] = vm_i(st[sp - 1].i & st[sp].i); break;
      case OP_OR: --sp; st[sp - 1] = vm_i(st[sp - 1].i | st[sp].i); break;
      case OP_SELECT:
        sp -= 2;
        st[sp - 1] = st[sp - 1].i ? st[sp] : st[sp + 1];
        break;
      default: st[sp - 1] = vm_unary(op, vt, st[sp - 1]); break;
    }
  }
  return st[0];
}
