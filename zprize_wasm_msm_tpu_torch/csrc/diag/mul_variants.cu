// Montgomery product variants on the H100: which form the field core's
// fe_mul takes (field.cuh), and how fast the inlined mixed add runs with
// and without enough warps.  A diagnostic, not part of any MSM path:
//
//     bash zprize_wasm_msm_tpu_torch/csrc/diag/run_mul_variants.sh
//
// builds this file with nvcc (sm_90a), runs it on the card and prints, per
// variant and launch size, the time of a loop of dependent products (one
// chain per thread; 1 block = one warp per scheduler of one SM is the
// latency case), then the SASS instruction mix of each loop.  Variants at
// NW = 12 (BLS12-381 Fq):
//   A  the port's earlier product: 64-bit C, NW+2 words.  Kept here only as
//      the baseline of PERF.md's table of these numbers; no kernel uses it;
//   B  the no-carry CIOS as PTX carry chains: field.cuh's fe_mul_cc;
//   C  the no-carry CIOS in 64-bit C, NW+1 words: field.cuh's fe_mul.
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "../group.cuh"

// A: the earlier product (64-bit C, NW+2 accumulator)
template <int NW>
__device__ __forceinline__ void old_cond_sub(Fe<NW>& r, const uint32_t* s, uint32_t carry_in) {
  uint32_t d[NW]; uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) { uint64_t t = (uint64_t)s[i] - c_fc.q[i] - borrow; d[i] = (uint32_t)t; borrow = t >> 63; }
  bool ge = (carry_in != 0u) || (borrow == 0);
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = ge ? d[i] : s[i];
}
template <int NW>
__device__ __forceinline__ void mul_A(Fe<NW>& r, const Fe<NW>& a, const Fe<NW>& b) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int i = 0; i < NW + 2; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0; const uint32_t bi = b.w[i];
#pragma unroll
    for (int j = 0; j < NW; ++j) { uint64_t s = (uint64_t)a.w[j] * bi + t[j] + c; t[j] = (uint32_t)s; c = s >> 32; }
    uint64_t s = (uint64_t)t[NW] + c; t[NW] = (uint32_t)s; t[NW + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * c_fc.np;
    s = (uint64_t)m * c_fc.q[0] + t[0]; c = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) { s = (uint64_t)m * c_fc.q[j] + t[j] + c; t[j - 1] = (uint32_t)s; c = s >> 32; }
    s = (uint64_t)t[NW] + c; t[NW - 1] = (uint32_t)s; t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
  }
  old_cond_sub<NW>(r, t, t[NW]);
}
template <int V, int NW>
__device__ __forceinline__ void mulv(Fe<NW>& r, const Fe<NW>& a, const Fe<NW>& b) {
  if (V == 0) mul_A<NW>(r, a, b);
  else if (V == 1) fe_mul_cc<NW>(r, a, b);
  else fe_mul<NW>(r, a, b);
}

template <int V>
__global__ void __launch_bounds__(64) mul_loop(const uint32_t* in, uint32_t* out, int iters) {
  constexpr int NW = 12;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Fe<NW> x, y;
  for (int k = 0; k < NW; ++k) { x.w[k] = in[k] ^ (i & 7); y.w[k] = in[NW + k]; }
  x.w[NW - 1] = in[NW - 1];
  for (int it = 0; it < iters; ++it) mulv<V, NW>(x, x, y);
  for (int k = 0; k < NW; ++k) out[(size_t)i * NW + k] = x.w[k];
}

__global__ void __launch_bounds__(64) add_loop(const uint32_t* in, uint32_t* out, int iters) {
  constexpr int NW = 12;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Pt<NW> acc; Fe<NW> x, y;
  for (int k = 0; k < NW; ++k) { acc.x.w[k] = in[k]; acc.y.w[k] = in[NW + k]; acc.z.w[k] = in[k] ^ (i & 3); x.w[k] = in[NW + k]; y.w[k] = in[k]; }
  acc.z.w[NW - 1] = in[NW - 1];
  for (int it = 0; it < iters; ++it) pt_add_mixed<NW>(acc, x, y);
  const uint32_t* a = reinterpret_cast<const uint32_t*>(&acc);
  for (int k = 0; k < 3 * NW; ++k) out[(size_t)i * 3 * NW + k] = a[k];
}

int main() {
  const uint32_t q[12] = {0xffffaaab, 0xb9feffff, 0xb153ffff, 0x1eabfffe, 0xf6b0f624, 0x6730d2a0,
                          0xf38512bf, 0x64774b84, 0x434bacd7, 0x4b1ba7b6, 0x397fe69a, 0x1a0111ea};
  FieldConsts h{};
  for (int k = 0; k < 12; ++k) { h.q[k] = q[k]; h.one[k] = q[k] >> 1; h.b3[k] = q[k] >> 2; }
  h.np = 0xfffcfffd;
  cudaMemcpyToSymbol(c_fc, &h, sizeof(h));
  std::vector<uint32_t> hin(24);
  for (int k = 0; k < 24; ++k) hin[k] = (q[k % 12] >> 1) ^ (0x9e3779b9u * (k + 1)) ;
  hin[11] = q[11] >> 2; hin[23] = q[11] >> 3;
  uint32_t *din, *dout; cudaMalloc(&din, 96); cudaMalloc(&dout, (size_t)132 * 64 * 64 * 36 * 4);
  cudaMemcpy(din, hin.data(), 96, cudaMemcpyHostToDevice);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  std::vector<uint32_t> ref;
  auto run = [&](const char* name, auto kern, int blocks, int iters, int per_iter_products) {
    kern<<<blocks, 64>>>(din, dout, 4);
    cudaDeviceSynchronize();
    cudaEventRecord(e0);
    kern<<<blocks, 64>>>(din, dout, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms; cudaEventElapsedTime(&ms, e0, e1);
    double ops = (double)blocks * 64 * iters;
    printf("%-28s blocks %6d threads %7d iters %5d: %9.3f ms  %8.3f ns/op/SM-thread-op  %.3e ops/s (%.3e products/s)\n", name, blocks, blocks * 64, iters, ms,
           ms * 1e6 / ops * 132, ops / (ms * 1e-3), ops * per_iter_products / (ms * 1e-3));
    std::vector<uint32_t> o(12); cudaMemcpy(o.data(), dout, 48, cudaMemcpyDeviceToHost);
    printf("   out[0..2] %08x %08x %08x err=%s\n", o[0], o[1], o[2], cudaGetErrorString(cudaGetLastError()));
  };
  for (int blocks : {1, 368, 608, 792, 1584}) {
    run("mul A (NW+2 words, 64-bit C)", mul_loop<0>, blocks, 2048, 1);
    run("mul B (PTX chains, fe_mul_cc)", mul_loop<1>, blocks, 2048, 1);
    run("mul C (no-carry 64-bit C, fe_mul)", mul_loop<2>, blocks, 2048, 1);
  }
  for (int blocks : {1, 368, 608, 792, 1584})
    run("add_mixed (chains, inlined)", add_loop, blocks, 256, 11);
  return 0;
}
