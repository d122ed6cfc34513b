// Test kernels that expose the device functions of field.cuh / group.cuh one
// operation at a time, so they can be held bit for bit against the plain
// PyTorch field and group ops (the role the JAX package's
// tests/test_kernels.py run_kcore_binop / test_kgroup_matches_group play for
// kcore / kgroup).  No MSM path launches these.

#include <cuda_runtime.h>

#include "fold2.cuh"

// a, b, r: [EXT NW][n] words.  op: 0 mul, 1 add, 2 sub, 3 neg (of a), 4
// mul_cc (over Fq the carry-chain product of the Fq sweeps; over Fq2 the
// one Fq2 product, as op 0), 5 the product by 3b (over Fq k * a by
// additions, fe_mul_small, k = b3k: the fold's group ops take it so; over
// Fq2 a product by the constant 3b), 7 square (over Fq field.cuh fe_sqr,
// over Fq2 the complex squaring of field2.cuh), 8 (Fq2 only) 3b a as
// additions, par.cuh fe_mul_b3k with k = b3k.
template <int NW, int EXT>
__global__ void field_op_kernel(int op, const uint32_t* a, const uint32_t* b, uint32_t* r,
                                int n, uint32_t b3k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Elem<NW, EXT> x, y, z;
  fe_load_soa<NW>(x, a, (size_t)n, (size_t)i);
  fe_load_soa<NW>(y, b, (size_t)n, (size_t)i);
  if (op == 0) fe_mul<NW>(z, x, y);
  else if (op == 1) fe_add<NW>(z, x, y);
  else if (op == 2) fe_sub<NW>(z, x, y);
  else if (op == 3) fe_neg<NW>(z, x);
  else if (op == 4) {
    if constexpr (EXT == 1) fe_mul_cc<NW>(z, x, y);
    else fe_mul<NW>(z, x, y);  // Fq2 has one product form (field2.cuh)
  }
  else if (op == 5) {
    if constexpr (EXT == 1) {
      fe_mul_small<NW>(z, x, b3k);
    } else {
      fe_b3<NW>(y);
      fe_mul<NW>(z, y, x);
    }
  } else if (op == 7) {
    fe_sqr<NW>(z, x);
  } else {
    if constexpr (EXT == 2) fe_mul_b3k<NW>(z, x, b3k);
    else z = x;  // refused by the entry point
  }
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

// The Fq2 group ops K1 and K4 run (group2.cuh, points in shared memory): op
// 0 add_mixed (q's x, y as the affine operand), 3 add_cc (K4's complete
// add).  p, q, r: [3][2 NW][n] words; blocks of FQ2_BLOCK threads.
template <int NW>
__global__ void __launch_bounds__(FQ2_BLOCK, 1)
    group2_op_kernel(int op, const uint32_t* p, const uint32_t* q, uint32_t* r, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  __shared__ Pt<NW, 2> sh[2][FQ2_BLOCK];
  Pt<NW, 2>& a = sh[0][threadIdx.x];
  Pt<NW, 2>& b = sh[1][threadIdx.x];
  pt_load_soa<NW>(a, p, (size_t)n, (size_t)i);
  pt_load_soa<NW>(b, q, (size_t)n, (size_t)i);
  if (op == 0) pt2_add_mixed_sh<NW>(a, b.x, stage_elems<NW>());
  else pt2_add_sh<NW>(a, b, stage_elems<NW>());
  pt_store_soa<NW>(r, (size_t)n, (size_t)i, a);
}

// fe_mul_coop: coop_lanes<NW>() lanes per element; the grid is whole warps,
// lanes past the batch run on its last element.  a, b, r: [EXT NW][n] words.
template <int NW, int EXT>
__global__ void __launch_bounds__(64)
    field_coop_kernel(const uint32_t* a, const uint32_t* b, uint32_t* r, int n) {
  constexpr int PL = coop_lanes<NW>();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = min(t / PL, n - 1);
  Elem<NW, EXT> x, y, z;
  fe_load_soa<NW>(x, a, (size_t)n, (size_t)i);
  fe_load_soa<NW>(y, b, (size_t)n, (size_t)i);
  fe_mul_coop<NW, PL>(z, x, y, t % PL);
  if (t % PL == 0 && t / PL < n) fe_store_soa<NW>(r, (size_t)n, (size_t)i, z);
}

// The level-parallel forms (par.cuh) on 8 PL lanes per point, PL = 1 (a
// product to a lane; Fq only) or coop_lanes<NW>() (cooperative products);
// the grid is whole warps, lanes past the batch run on its last point.  op:
// 0 double (of p), 1 add.  Over Fq2 the group's points are its shared slots.
template <int NW, int PL, int EXT>
__global__ void __launch_bounds__(64)
    group_par_kernel(int op, const uint32_t* p, const uint32_t* q, uint32_t* r, int n,
                     uint32_t b3k) {
  constexpr int GL = 8 * PL, GS = 64 / GL;
  const int t = blockIdx.x * blockDim.x + threadIdx.x, sub = t % GL;
  const int i = min(t / GL, n - 1), g = threadIdx.x / GL;
  Pt<NW, EXT> a_own, b_own;
  Pt<NW, EXT>& a = work_point<NW, EXT, 2 * GS>(a_own, g);
  Pt<NW, EXT>& b = work_point<NW, EXT, 2 * GS>(b_own, GS + g);
  pt_load_soa<NW>(a, p, (size_t)n, (size_t)i);
  pt_load_soa<NW>(b, q, (size_t)n, (size_t)i);
  if (op == 0) pt_double_par<NW, PL>(a, sub, b3k);
  else pt_add_par<NW, PL>(a, a, b, sub, b3k);
  if (sub == 0 && t / GL < n) pt_store_soa<NW>(r, (size_t)n, (size_t)i, a);
}

// Each warp of one block (one SM) runs `reps` dependent level-parallel ops
// on one point: op 0 doublings of p, op 1 additions of q into p (the links
// of the window fold's chain and of the collapse's, timed by chip_smoke.py
// for their depth floors, alone and beside other warps on the SM).  p, q,
// r: [3][EXT NW][1] words.
template <int NW, int PL, int EXT>
__global__ void __launch_bounds__(128)
    group_chain_kernel(int op, const uint32_t* p, const uint32_t* q, uint32_t* r, int reps,
                       uint32_t b3k) {
  constexpr int GL = 8 * PL, GS = 128 / GL;
  const int sub = threadIdx.x % GL, g = threadIdx.x / GL;
  Pt<NW, EXT> a_own, b_own;
  Pt<NW, EXT>& a = work_point<NW, EXT, 2 * GS>(a_own, g);
  Pt<NW, EXT>& b = work_point<NW, EXT, 2 * GS>(b_own, GS + g);
  pt_load_soa<NW>(a, p, 1, 0);
  pt_load_soa<NW>(b, q, 1, 0);
  for (int i = 0; i < reps; ++i) {
    if (op == 0) pt_double_par<NW, PL>(a, sub, b3k);
    else pt_add_par<NW, PL>(a, a, b, sub, b3k);
  }
  if (threadIdx.x == 0) pt_store_soa<NW>(r, 1, 0, a);
}

// The window fold's Fq2 links (fold2.cuh) in the form <PL, NT>: one block
// of NT threads a point.  group: op 0 double (of p), 1 add (q into p), one
// op on point blockIdx.x of n; chain: `reps` dependent ops on one point (the
// fold's link, timed by chip_smoke.py).  p, q, r: [3][2 NW][n] words.
template <int NW, int PL, int NT>
__global__ void __launch_bounds__(NT, 1)
    fold2_op_kernel(int op, const uint32_t* p, const uint32_t* q, uint32_t* r, int n, int reps,
                    uint32_t b3k) {
  __shared__ PtK<NW> a, b;
  __shared__ Fold2Sh<NW> sh;
  const int i = blockIdx.x;
  fold2_load<NW>(a, p, (size_t)n, (size_t)i);
  fold2_load<NW>(b, q, (size_t)n, (size_t)i);
  for (int k = 0; k < reps; ++k) {
    if (op == 0) fold2_link_double<NW, PL, NT>(&a, &sh, b3k);
    else fold2_link_add<NW, PL, NT>(&a, &a, &b, &sh, b3k);
  }
  if (threadIdx.x == 0) fold2_store<NW>(r, (size_t)n, (size_t)i, a);
}

// fold2_op_kernel's two forms: form 0 a block of three warps, a unit of
// coop_lanes lanes an Fq product; form 1 one warp, a lane a product.
template <int NW>
static void fold2_launch(int form, int op, const uint32_t* p, const uint32_t* q, uint32_t* r,
                         int n, int reps, uint32_t b3k, cudaStream_t stream) {
  if (form == 0)
    fold2_op_kernel<NW, coop_lanes<NW>(), 96><<<n, 96, 0, stream>>>(op, p, q, r, n, reps, b3k);
  else
    fold2_op_kernel<NW, 1, 32><<<n, 32, 0, stream>>>(op, p, q, r, n, reps, b3k);
}

// One warp, each lane running `reps` dependent one-lane complete adds of q
// into p (pt_add_acc as the segmented scan runs it: over Fq in registers on
// the 64-bit-row product, over Fq2 on points in shared memory).
template <int NW, int EXT>
__global__ void __launch_bounds__(FQ2_BLOCK, 1)
    lane_chain_kernel(const uint32_t* p, const uint32_t* q, uint32_t* r, int reps) {
  if constexpr (EXT == 1) {
    Pt<NW> a, b;
    pt_load_soa<NW>(a, p, 1, 0);
    pt_load_soa<NW>(b, q, 1, 0);
    for (int i = 0; i < reps; ++i) pt_add_acc<NW, false>(a, b);
    if (threadIdx.x == 0) pt_store_soa<NW>(r, 1, 0, a);
  } else {
    __shared__ Pt<NW, EXT> sh[2][FQ2_BLOCK];
    Pt<NW, EXT>& a = sh[0][threadIdx.x];
    Pt<NW, EXT>& b = sh[1][threadIdx.x];
    pt_load_soa<NW>(a, p, 1, 0);
    pt_load_soa<NW>(b, q, 1, 0);
    for (int i = 0; i < reps; ++i) pt_add_acc<NW, true>(a, b);
    if (threadIdx.x == 0) pt_store_soa<NW>(r, 1, 0, a);
  }
}

// op 0-5, 7: field_op_kernel, one thread per element; 6: fe_mul_coop.
extern "C" int zp_field_op(int nw, int ext, const uint32_t* host_consts, uint32_t b3k, int op,
                           const uint32_t* a, const uint32_t* b, uint32_t* r, int n,
                           void* stream_ptr) {
  if ((ext == 1 && op == 5 && b3k == 0) || (op == 8 && b3k == 0)) return -5;
  if (op == 8 && ext != 2) return -1;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
  if (op != 6) {
#define CALL(NW_, EXT_) \
  field_op_kernel<NW_, EXT_><<<(n + 63) / 64, 64, 0, stream>>>(op, a, b, r, n, b3k)
    ZP_DISPATCH_NW_EXT(nw, ext, CALL)
#undef CALL
  } else {
#define CALL(NW_, EXT_)                                                           \
  field_coop_kernel<NW_, EXT_><<<(n * coop_lanes<NW_>() + 63) / 64, 64, 0, stream>>>(a, b, r, n)
    ZP_DISPATCH_NW_EXT(nw, ext, CALL)
#undef CALL
  }
  return (int)cudaGetLastError();
}

// op 0-3: group_op_kernel, one thread per point (over Fq2 ops 0 and 3:
// group2_op_kernel); 4, 5: group_par_kernel double / add with a product to a
// lane (Fq only); 6, 7: the same with cooperative products; 8-11 (Fq2
// only): the fold's links, double / add of form 0 (8, 9) and of form 1
// (10, 11), a block a point.
extern "C" int zp_group_op(int nw, int ext, const uint32_t* host_consts, uint32_t b3k, int op,
                           const uint32_t* p, const uint32_t* q, uint32_t* r, int n,
                           void* stream_ptr) {
  if (ext == 1 && op >= 4 && b3k == 0) return -5;
  if (ext != 1 && (op == 1 || op == 2 || op == 4 || op == 5)) return -1;
  if (op > 11 || (ext == 1 && op >= 8)) return -1;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
  if (op >= 8) {
#define CALL(NW_) fold2_launch<NW_>((op - 8) / 2, op % 2, p, q, r, n, 1, b3k, stream)
    ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  } else if (op < 4 && ext == 1) {
#define CALL(NW_) group_op_kernel<NW_><<<(n + 63) / 64, 64, 0, stream>>>(op, p, q, r, n)
    ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  } else if (op < 4) {
#define CALL(NW_) \
  group2_op_kernel<NW_><<<(n + FQ2_BLOCK - 1) / FQ2_BLOCK, FQ2_BLOCK, 0, stream>>>(op, p, q, r, n)
    ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  } else if (op < 6) {
#define CALL(NW_) \
  group_par_kernel<NW_, 1, 1><<<(n * 8 + 63) / 64, 64, 0, stream>>>(op - 4, p, q, r, n, b3k)
    ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  } else {
#define CALL(NW_, EXT_)                                                             \
  group_par_kernel<NW_, coop_lanes<NW_>(), EXT_>                                    \
      <<<(n * 8 * coop_lanes<NW_>() + 63) / 64, 64, 0, stream>>>(op - 6, p, q, r, n, b3k)
    ZP_DISPATCH_NW_EXT(nw, ext, CALL)
#undef CALL
  }
  return (int)cudaGetLastError();
}

// op 0 / 1: doublings / additions with a product to a lane (Fq only); 2 /
// 3: with cooperative products, on `warps` warps of one block (1, 2 or 4);
// 4: one-lane complete additions (one warp); 5 / 6 and 7 / 8 (Fq2 only):
// the fold's doublings / additions in form 0 and form 1 (fold2_launch),
// one block.
extern "C" int zp_group_chain(int nw, int ext, const uint32_t* host_consts, uint32_t b3k,
                              int op, const uint32_t* p, const uint32_t* q, uint32_t* r,
                              int reps, int warps, void* stream_ptr) {
  if (ext == 1 && b3k == 0) return -5;
  if ((ext != 1 && op < 2) || op > 8 || warps < 1 || warps > 4 || (op >= 4 && warps != 1)) return -1;
  if (ext == 1 && op >= 5) return -1;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
  if (op >= 5) {
#define CALL(NW_) fold2_launch<NW_>((op - 5) / 2, (op - 5) % 2, p, q, r, 1, reps, b3k, stream)
    ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  } else if (op < 2) {
#define CALL(NW_) \
  group_chain_kernel<NW_, 1, 1><<<1, 32 * warps, 0, stream>>>(op, p, q, r, reps, b3k)
    ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  } else if (op < 4) {
#define CALL(NW_, EXT_)                                    \
  group_chain_kernel<NW_, coop_lanes<NW_>(), EXT_>         \
      <<<1, 32 * warps, 0, stream>>>(op - 2, p, q, r, reps, b3k)
    ZP_DISPATCH_NW_EXT(nw, ext, CALL)
#undef CALL
  } else {
#define CALL(NW_, EXT_) lane_chain_kernel<NW_, EXT_><<<1, FQ2_BLOCK, 0, stream>>>(p, q, r, reps)
    ZP_DISPATCH_NW_EXT(nw, ext, CALL)
#undef CALL
  }
  return (int)cudaGetLastError();
}
