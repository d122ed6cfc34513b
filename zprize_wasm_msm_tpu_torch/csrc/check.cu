// Test kernels that expose the device functions of field.cuh / group.cuh one
// operation at a time, so they can be held bit for bit against the plain
// PyTorch field and group ops (the role the JAX package's
// tests/test_kernels.py run_kcore_binop / test_kgroup_matches_group play for
// kcore / kgroup).  No MSM path launches these.

#include <cuda_runtime.h>

#include "group.cuh"

// a, b, r: [NW][n] words.  op: 0 mul, 1 add, 2 sub, 3 neg (of a), 4 mul_cc
// (the carry-chain product of the sweeps).
template <int NW>
__global__ void field_op_kernel(int op, const uint32_t* a, const uint32_t* b, uint32_t* r,
                                int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe<NW> x, y, z;
  fe_load_soa<NW>(x, a, (size_t)n, (size_t)i);
  fe_load_soa<NW>(y, b, (size_t)n, (size_t)i);
  if (op == 0) fe_mul<NW>(z, x, y);
  else if (op == 1) fe_add<NW>(z, x, y);
  else if (op == 2) fe_sub<NW>(z, x, y);
  else if (op == 3) fe_neg<NW>(z, x);
  else fe_mul_cc<NW>(z, x, y);
  fe_store_soa<NW>(r, (size_t)n, (size_t)i, z);
}

// p, q, r: [3][NW][n] words.  op: 0 add_mixed (q's x, y as the affine
// operand), 1 add, 2 double (of p), 3 add_cc (the complete add on the
// carry-chain product, as K7's combine calls it).
template <int NW>
__global__ void __launch_bounds__(64)
    group_op_kernel(int op, const uint32_t* p, const uint32_t* q, uint32_t* r, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt<NW> a, b, out;
  pt_load_soa<NW>(a, p, (size_t)n, (size_t)i);
  pt_load_soa<NW>(b, q, (size_t)n, (size_t)i);
  if (op == 0) {
    out = a;
    pt_add_mixed<NW>(out, b.x, b.y);
  } else if (op == 1) pt_add<NW>(&out, &a, &b);
  else if (op == 2) pt_double<NW>(&out, &a);
  else pt_add<NW, true>(&out, &a, &b);
  pt_store_soa<NW>(r, (size_t)n, (size_t)i, out);
}

extern "C" int zp_field_op(int nw, const uint32_t* host_consts, int op, const uint32_t* a,
                           const uint32_t* b, uint32_t* r, int n, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
#define CALL(NW_) field_op_kernel<NW_><<<(n + 63) / 64, 64, 0, stream>>>(op, a, b, r, n)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  return (int)cudaGetLastError();
}

extern "C" int zp_group_op(int nw, const uint32_t* host_consts, int op, const uint32_t* p,
                           const uint32_t* q, uint32_t* r, int n, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
#define CALL(NW_) group_op_kernel<NW_><<<(n + 63) / 64, 64, 0, stream>>>(op, p, q, r, n)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  return (int)cudaGetLastError();
}
