// Test kernels that expose the device functions of field.cuh / group.cuh one
// operation at a time, so they can be held bit for bit against the plain
// PyTorch field and group ops (the role the JAX package's
// tests/test_kernels.py run_kcore_binop / test_kgroup_matches_group play for
// kcore / kgroup).  No MSM path launches these.

#include <cuda_runtime.h>

#include "par.cuh"

// a, b, r: [NW][n] words.  op: 0 mul, 1 add, 2 sub, 3 neg (of a), 4 mul_cc
// (the carry-chain product of the sweeps), 5 k * a by additions
// (fe_mul_small, k = b3k: the product by 3b of the fold's group ops).
template <int NW>
__global__ void field_op_kernel(int op, const uint32_t* a, const uint32_t* b, uint32_t* r,
                                int n, uint32_t b3k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe<NW> x, y, z;
  fe_load_soa<NW>(x, a, (size_t)n, (size_t)i);
  fe_load_soa<NW>(y, b, (size_t)n, (size_t)i);
  if (op == 0) fe_mul<NW>(z, x, y);
  else if (op == 1) fe_add<NW>(z, x, y);
  else if (op == 2) fe_sub<NW>(z, x, y);
  else if (op == 3) fe_neg<NW>(z, x);
  else if (op == 4) fe_mul_cc<NW>(z, x, y);
  else fe_mul_small<NW>(z, x, b3k);
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

// fe_mul_coop: coop_lanes<NW>() lanes per element; the grid is whole warps,
// lanes past the batch run on its last element.  a, b, r: [NW][n] words.
template <int NW>
__global__ void __launch_bounds__(64)
    field_coop_kernel(const uint32_t* a, const uint32_t* b, uint32_t* r, int n) {
  constexpr int PL = coop_lanes<NW>();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = min(t / PL, n - 1);
  Fe<NW> x, y, z;
  fe_load_soa<NW>(x, a, (size_t)n, (size_t)i);
  fe_load_soa<NW>(y, b, (size_t)n, (size_t)i);
  fe_mul_coop<NW, PL>(z, x, y, t % PL);
  if (t % PL == 0 && t / PL < n) fe_store_soa<NW>(r, (size_t)n, (size_t)i, z);
}

// The level-parallel forms (par.cuh) on 8 PL lanes per point, PL = 1 (a
// product to a lane) or coop_lanes<NW>() (cooperative products); the grid
// is whole warps, lanes past the batch run on its last point.  op: 0
// double (of p), 1 add.
template <int NW, int PL>
__global__ void __launch_bounds__(64)
    group_par_kernel(int op, const uint32_t* p, const uint32_t* q, uint32_t* r, int n,
                     uint32_t b3k) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x, sub = t % (8 * PL);
  const int i = min(t / (8 * PL), n - 1);
  Pt<NW> a, b;
  pt_load_soa<NW>(a, p, (size_t)n, (size_t)i);
  pt_load_soa<NW>(b, q, (size_t)n, (size_t)i);
  if (op == 0) pt_double_par<NW, PL>(a, sub, b3k);
  else pt_add_par<NW, PL>(a, a, b, sub, b3k);
  if (sub == 0 && t / (8 * PL) < n) pt_store_soa<NW>(r, (size_t)n, (size_t)i, a);
}

// One warp runs `reps` dependent level-parallel ops on one point: op 0
// doublings of p, op 1 additions of q into p (the links of the window
// fold's chain, timed by chip_smoke.py for K3's depth floor).  p, q, r:
// [3][NW][1] words.
template <int NW, int PL>
__global__ void __launch_bounds__(32)
    group_chain_kernel(int op, const uint32_t* p, const uint32_t* q, uint32_t* r, int reps,
                       uint32_t b3k) {
  const int sub = threadIdx.x % (8 * PL);
  Pt<NW> a, b;
  pt_load_soa<NW>(a, p, 1, 0);
  pt_load_soa<NW>(b, q, 1, 0);
  for (int i = 0; i < reps; ++i) {
    if (op == 0) pt_double_par<NW, PL>(a, sub, b3k);
    else pt_add_par<NW, PL>(a, a, b, sub, b3k);
  }
  if (threadIdx.x == 0) pt_store_soa<NW>(r, 1, 0, a);
}

// op 0-5: field_op_kernel, one thread per element; 6: fe_mul_coop.
extern "C" int zp_field_op(int nw, const uint32_t* host_consts, uint32_t b3k, int op,
                           const uint32_t* a, const uint32_t* b, uint32_t* r, int n,
                           void* stream_ptr) {
  if (op == 5 && b3k == 0) return -5;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
  if (op < 6) {
#define CALL(NW_) field_op_kernel<NW_><<<(n + 63) / 64, 64, 0, stream>>>(op, a, b, r, n, b3k)
    ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  } else {
#define CALL(NW_)                                             \
  field_coop_kernel<NW_><<<(n * coop_lanes<NW_>() + 63) / 64, 64, 0, stream>>>(a, b, r, n)
    ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  }
  return (int)cudaGetLastError();
}

// op 0-3: group_op_kernel, one thread per point; 4, 5: group_par_kernel
// double / add with a product to a lane; 6, 7: the same with cooperative
// products.
extern "C" int zp_group_op(int nw, const uint32_t* host_consts, uint32_t b3k, int op,
                           const uint32_t* p, const uint32_t* q, uint32_t* r, int n,
                           void* stream_ptr) {
  if (op >= 4 && b3k == 0) return -5;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
  if (op < 4) {
#define CALL(NW_) group_op_kernel<NW_><<<(n + 63) / 64, 64, 0, stream>>>(op, p, q, r, n)
    ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  } else if (op < 6) {
#define CALL(NW_) \
  group_par_kernel<NW_, 1><<<(n * 8 + 63) / 64, 64, 0, stream>>>(op - 4, p, q, r, n, b3k)
    ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  } else {
#define CALL(NW_)                                                                   \
  group_par_kernel<NW_, coop_lanes<NW_>()>                                          \
      <<<(n * 8 * coop_lanes<NW_>() + 63) / 64, 64, 0, stream>>>(op - 6, p, q, r, n, b3k)
    ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  }
  return (int)cudaGetLastError();
}

// op 0 / 1: doublings / additions with a product to a lane; 2 / 3: with
// cooperative products.
extern "C" int zp_group_chain(int nw, const uint32_t* host_consts, uint32_t b3k, int op,
                              const uint32_t* p, const uint32_t* q, uint32_t* r, int reps,
                              void* stream_ptr) {
  if (b3k == 0) return -5;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
  if (op < 2) {
#define CALL(NW_) group_chain_kernel<NW_, 1><<<1, 32, 0, stream>>>(op, p, q, r, reps, b3k)
    ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  } else {
#define CALL(NW_)                                   \
  group_chain_kernel<NW_, coop_lanes<NW_>()>        \
      <<<1, 32, 0, stream>>>(op - 2, p, q, r, reps, b3k)
    ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  }
  return (int)cudaGetLastError();
}
