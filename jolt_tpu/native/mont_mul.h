// BN254 field ops on one element — Montgomery multiply, modular add and
// subtract — shared by the CUDA kernels (mont_mul.cu) and their host build
// for tests (mont_mul_host.cc).
//
// Operands and result use the prover's limb layout: 16 little-endian
// 16-bit limbs, each in a uint32, Montgomery form with R = 2^256.  The
// element is packed into 8 32-bit words and multiplied by CIOS (coarsely
// integrated operand scanning) with 64-bit partial products.  CIOS yields
// exactly (a*b + m*p) / R with m = -a*b*p^-1 mod R, the value the plain
// XLA path (field/device.py: _mont_redc(_carry(_mul_columns(...)))) forms;
// like that path, the word above 2^256 is dropped before the one
// conditional subtraction of p, so the two agree bit for bit.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define JOLT_HD __host__ __device__ __forceinline__
#else
#define JOLT_HD inline
#endif

enum JoltFieldOp { JOLT_MUL = 0, JOLT_ADD = 1, JOLT_SUB = 2 };

// 16 strided 16-bit limbs <-> 8 32-bit words
JOLT_HD void jolt_load_words(const uint32_t* x, int64_t stride, uint32_t* w) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    w[k] = (x[(2 * k) * stride] & 0xFFFFu) |
           ((x[(2 * k + 1) * stride] & 0xFFFFu) << 16);
  }
}

JOLT_HD void jolt_store_words(const uint32_t* w, int64_t stride,
                              uint32_t* x) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    x[(2 * k) * stride] = w[k] & 0xFFFFu;
    x[(2 * k + 1) * stride] = w[k] >> 16;
  }
}

// d = x - y mod 2^256; returns the borrow out of the top word
JOLT_HD uint32_t jolt_sub_words(const uint32_t* x, const uint32_t* y,
                                uint32_t* d) {
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint64_t v = (uint64_t)x[k] - y[k] - borrow;
    d[k] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  return borrow;
}

// s = x + y mod 2^256 (the carry out of the top word drops, as in the
// plain path's carry over 16 limbs)
JOLT_HD void jolt_add_words(const uint32_t* x, const uint32_t* y,
                            uint32_t* s) {
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c += (uint64_t)x[k] + y[k];
    s[k] = (uint32_t)c;
    c >>= 32;
  }
}

// (a + b) mod p: the plain path's _cond_sub_p(_carry(a + b))
JOLT_HD void jolt_add_mod(const uint32_t* A, const uint32_t* B,
                          const uint32_t* P, uint32_t* out) {
  uint32_t s[8], d[8];
  jolt_add_words(A, B, s);
  const uint32_t borrow = jolt_sub_words(s, P, d);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = borrow ? s[k] : d[k];
}

// (a - b) mod p: the plain path's borrow ? _carry(d + p) : d
JOLT_HD void jolt_sub_mod(const uint32_t* A, const uint32_t* B,
                          const uint32_t* P, uint32_t* out) {
  uint32_t d[8], dp[8];
  const uint32_t borrow = jolt_sub_words(A, B, d);
  jolt_add_words(d, P, dp);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = borrow ? dp[k] : d[k];
}

// Montgomery product a * b * R^-1 (CIOS) with one conditional subtraction
JOLT_HD void jolt_mont_mul(const uint32_t* A, const uint32_t* B,
                           const uint32_t* P, uint32_t n0, uint32_t* out) {
  uint32_t t[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)A[i] * B[j] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * n0;
    s = (uint64_t)m * P[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)m * P[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  // t[0..7] = (a*b + m*p) / R mod 2^256; subtract p once if it is >= p
  uint32_t d[8];
  const uint32_t borrow = jolt_sub_words(t, P, d);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = borrow ? t[k] : d[k];
}

// One element of op(a, b).  a, b, out point at limb 0 of the element;
// limbs are `stride` apart.  consts: p as 8 little-endian 32-bit words,
// then n0 = -p^-1 mod 2^32.
JOLT_HD void jolt_field_op_elem(int op, const uint32_t* a, const uint32_t* b,
                                int64_t stride, const uint32_t* consts,
                                uint32_t* out) {
  uint32_t A[8], B[8], P[8], R[8];
  jolt_load_words(a, stride, A);
  jolt_load_words(b, stride, B);
#pragma unroll
  for (int k = 0; k < 8; ++k) P[k] = consts[k];
  if (op == JOLT_MUL) {
    jolt_mont_mul(A, B, P, consts[8], R);
  } else if (op == JOLT_ADD) {
    jolt_add_mod(A, B, P, R);
  } else {
    jolt_sub_mod(A, B, P, R);
  }
  jolt_store_words(R, stride, out);
}
