// K2 intra_pred: HEVC intra prediction (H.265 8.4.4.2), bit-exact with
// hmtpu/ops/intra_pred.py:230 filter_reference_batched (hm_intra_filter)
// and :69 predict_all_modes / :149 predict_one_mode (hm_intra_pred).
//
// What bounds it on the H100: the data are small int32 reference lines
// (4N+1 samples per block) and int32 predictions; every output sample
// costs a handful of integer operations, and one block's lines are read
// by up to 35 * N * N outputs.  At the encoder's batch sizes (up to a
// few thousand blocks in the rough mode decision, a handful in the
// z-scan) the call is bound by launch cost, then by the bytes of the
// predictions it writes.
//
// Design (the arithmetic is intra_pred.cuh's, shared with K21 and K22):
// hm_intra_pred runs one thread block per reference line: the
// unfiltered and filtered lines and the block's DC value are staged in
// shared memory, and the threads walk the block's (mode, y, x) outputs
// with coalesced writes.  The angular taps are derived per sample from
// the spec's angle tables (no gather tables in memory).
// hm_intra_filter runs one thread per reference sample.
#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_pred.cuh"

namespace {

__global__ void filter_kernel(const int* __restrict__ ref,
                              int* __restrict__ out, int nb, int n, int bd,
                              int strong) {
  const int line = 4 * n + 1;
  const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= (long long)nb * line) return;
  const int b = (int)(id / line);
  const int k = (int)(id - (long long)b * line);
  out[id] = hm::filter_sample(ref + (long long)b * line, k, n, bd, strong);
}

__global__ void pred_kernel(const int* __restrict__ ref_u,
                            const int* __restrict__ ref_f,
                            const int* __restrict__ modes,
                            int* __restrict__ out, int m_per, int n,
                            int is_luma, int bd) {
  extern __shared__ int smem[];
  const int line = 4 * n + 1;
  int* su = smem;            // unfiltered line
  int* sf = smem + line;     // filtered line
  int* sdc = sf + line;      // DC value
  const int b = blockIdx.x;
  for (int k = threadIdx.x; k < line; k += blockDim.x) {
    su[k] = ref_u[(long long)b * line + k];
    sf[k] = ref_f[(long long)b * line + k];
  }
  __syncthreads();
  const int log2n = hm::log2_of(n);
  if (threadIdx.x == 0) sdc[0] = hm::intra_dc(su, n, log2n);
  __syncthreads();
  const int dc = sdc[0];
  const int nn = n * n;
  const int total = m_per * nn;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int mi = e / nn;
    const int yx = e - mi * nn;
    const int y = yx / n;
    const int x = yx - y * n;
    const int mode = modes[(long long)b * m_per + mi];
    out[(long long)b * total + e] =
        hm::pred_sample(su, sf, dc, mode, n, log2n, is_luma, bd, y, x);
  }
}

}  // namespace

extern "C" int hm_intra_filter(const void* ref, void* out, int nb, int n,
                               int bd, int strong, void* stream) {
  const long long total = (long long)nb * (4 * n + 1);
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  filter_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)ref, (int*)out, nb, n, bd, strong);
  return (int)cudaGetLastError();
}

extern "C" int hm_intra_pred(const void* ref_u, const void* ref_f,
                             const void* modes, void* out, int nb,
                             int m_per, int n, int is_luma, int bd,
                             void* stream) {
  const int total = m_per * n * n;
  const int threads = total >= 256 ? 256 : ((total + 31) / 32) * 32;
  const size_t smem = (size_t)(2 * (4 * n + 1) + 1) * sizeof(int);
  pred_kernel<<<nb, threads, smem, (cudaStream_t)stream>>>(
      (const int*)ref_u, (const int*)ref_f, (const int*)modes, (int*)out,
      m_per, n, is_luma, bd);
  return (int)cudaGetLastError();
}
