// BN254 field kernels for NVIDIA GPUs — Montgomery multiply, modular add
// and subtract — called from JAX through the XLA FFI (targets
// "jolt_mont_mul", "jolt_mont_add", "jolt_mont_sub"; field/mont_kernel.py).
//
// Operands a, b and the result are uint32 [P, 16, Q] limb tensors (P = 1
// for the limb-leading layout, P = batch for the GP pair layout); consts
// is uint32[9] (p words, n0).  One thread per element: limb i of
// neighbouring elements is contiguous, so every load and store coalesces.
#include <cuda_runtime.h>

#include "mont_mul.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

template <int Op>
__global__ void FieldOpKernel(const uint32_t* __restrict__ a,
                              const uint32_t* __restrict__ b,
                              const uint32_t* __restrict__ consts,
                              uint32_t* __restrict__ out, int64_t n,
                              int64_t q) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int64_t off = (idx / q) * 16 * q + idx % q;
  jolt_field_op_elem(Op, a + off, b + off, q, consts, out + off);
}

template <int Op>
ffi::Error FieldOpImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> a,
                       ffi::Buffer<ffi::U32> b, ffi::Buffer<ffi::U32> consts,
                       ffi::ResultBuffer<ffi::U32> out) {
  auto dims = a.dimensions();
  if (dims.size() != 3 || dims[1] != 16 || consts.element_count() != 9) {
    return ffi::Error::InvalidArgument(
        "jolt field op: operands must be uint32[P, 16, Q], consts [9]");
  }
  const int64_t q = dims[2];
  const int64_t n = dims[0] * q;
  if (n == 0) return ffi::Error::Success();
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  FieldOpKernel<Op><<<blocks, threads, 0, stream>>>(
      a.typed_data(), b.typed_data(), consts.typed_data(),
      out->typed_data(), n, q);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

#define JOLT_FIELD_OP_HANDLER(name, op)                         \
  XLA_FFI_DEFINE_HANDLER_SYMBOL(name, FieldOpImpl<op>,          \
                                ffi::Ffi::Bind()                \
                                    .Ctx<ffi::PlatformStream<cudaStream_t>>() \
                                    .Arg<ffi::Buffer<ffi::U32>>() \
                                    .Arg<ffi::Buffer<ffi::U32>>() \
                                    .Arg<ffi::Buffer<ffi::U32>>() \
                                    .Ret<ffi::Buffer<ffi::U32>>());

JOLT_FIELD_OP_HANDLER(JoltMontMul, JOLT_MUL)
JOLT_FIELD_OP_HANDLER(JoltMontAdd, JOLT_ADD)
JOLT_FIELD_OP_HANDLER(JoltMontSub, JOLT_SUB)
