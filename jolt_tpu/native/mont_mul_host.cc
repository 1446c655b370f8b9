// Host build of the GPU field kernels' arithmetic (mont_mul.h), for the
// CPU tests: same [P, 16, Q] layout, one loop iteration per element.
#include "mont_mul.h"

extern "C" void jolt_field_op_host(int op, const uint32_t* a,
                                   const uint32_t* b, const uint32_t* consts,
                                   uint32_t* out, int64_t p, int64_t q) {
  for (int64_t idx = 0; idx < p * q; ++idx) {
    const int64_t off = (idx / q) * 16 * q + idx % q;
    jolt_field_op_elem(op, a + off, b + off, q, consts, out + off);
  }
}
