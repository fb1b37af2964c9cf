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
// Design: hm_intra_pred runs one thread block per reference line: the
// unfiltered and filtered lines and the block's DC value are staged in
// shared memory, and the threads walk the block's (mode, y, x) outputs
// with coalesced writes.  The angular taps are derived per sample from
// the spec's angle tables (no gather tables in memory).
// hm_intra_filter runs one thread per reference sample.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// intraPredAngle, modes 2..34 (Table 8-5)
__constant__ int kAngles[33] = {32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5,
                                -9, -13, -17, -21, -26, -32, -26, -21,
                                -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17,
                                21, 26, 32};

__device__ __forceinline__ int inv_angle(int a) {
  switch (a) {
    case -2: return -4096;
    case -5: return -1638;
    case -9: return -910;
    case -13: return -630;
    case -17: return -482;
    case -21: return -390;
    case -26: return -315;
    case -32: return -256;
    default: return 0;
  }
}

// 8.4.4.2.3 filtering decision (should_filter in ops/intra_ref.py)
__device__ __forceinline__ bool uses_filtered(int mode, int n, int is_luma) {
  if (!is_luma || mode == 1 || n == 4) return false;
  int d = min(abs(mode - 26), abs(mode - 10));
  int thres = n == 8 ? 7 : (n == 16 ? 1 : 0);
  return d > thres;
}

__global__ void filter_kernel(const int* __restrict__ ref,
                              int* __restrict__ out, int nb, int n, int bd,
                              int strong) {
  const int line = 4 * n + 1;
  const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= (long long)nb * line) return;
  const int b = (int)(id / line);
  const int k = (int)(id - (long long)b * line);
  const int* r = ref + (long long)b * line;
  int v = r[k];
  if (k > 0 && k < line - 1) v = (r[k - 1] + 2 * r[k] + r[k + 1] + 2) >> 2;
  if (strong && n == 32) {
    const int thr = 1 << (bd - 5);
    const int corner = r[2 * n];
    const int topmid = r[2 * n + 1 + (n - 1)];
    const int topend = r[4 * n];
    const int leftmid = r[2 * n - 1 - (n - 1)];
    const int leftend = r[0];
    const bool bi = abs(corner + topend - 2 * topmid) < thr &&
                    abs(corner + leftend - 2 * leftmid) < thr;
    if (bi) {
      v = r[k];
      if (k >= 1 && k <= 2 * n - 1) {          // left column, y = 2n-1-k
        const int y = 2 * n - 1 - k;
        v = ((63 - y) * corner + (y + 1) * leftend + 32) >> 6;
      } else if (k >= 2 * n + 1 && k <= 4 * n - 1) {   // top row
        const int x = k - (2 * n + 1);
        v = ((63 - x) * corner + (x + 1) * topend + 32) >> 6;
      }
    }
  }
  out[id] = v;
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
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  if (threadIdx.x == 0) {
    int s = n;
    for (int i = 0; i < n; ++i) s += su[2 * n + 1 + i] + su[2 * n - 1 - i];
    sdc[0] = s >> (log2n + 1);
  }
  __syncthreads();
  const int dc = sdc[0];
  const int maxv = (1 << bd) - 1;
  const int nn = n * n;
  const int total = m_per * nn;
  const bool edge = is_luma && n < 32;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int mi = e / nn;
    const int yx = e - mi * nn;
    const int y = yx / n;
    const int x = yx - y * n;
    const int mode = modes[(long long)b * m_per + mi];
    const int* r = uses_filtered(mode, n, is_luma) ? sf : su;
    int v;
    if (mode == 0) {               // planar
      v = ((n - 1 - x) * r[2 * n - 1 - y] + (x + 1) * r[3 * n + 1] +
           (n - 1 - y) * r[2 * n + 1 + x] + (y + 1) * r[n - 1] + n) >>
          (log2n + 1);
    } else if (mode == 1) {        // DC
      v = dc;
      if (edge) {
        if (y == 0 && x == 0)
          v = (su[2 * n - 1] + 2 * dc + su[2 * n + 1] + 2) >> 2;
        else if (x == 0)
          v = (su[2 * n - 1 - y] + 3 * dc + 2) >> 2;
        else if (y == 0)
          v = (su[2 * n + 1 + x] + 3 * dc + 2) >> 2;
      }
    } else {                       // angular
      const int a = kAngles[mode - 2];
      const int inv = inv_angle(a);
      const bool vert = mode >= 18;
      const int major = vert ? y : x;
      const int minor = vert ? x : y;
      const int ii = ((major + 1) * a) >> 5;
      const int ff = ((major + 1) * a) & 31;
      const int t0 = minor + ii + 1;
      const int t1 = min(t0 + 1, 2 * n);
      int i0, i1;
      if (vert) {
        i0 = t0 >= 0 ? 2 * n + t0 : 2 * n - ((t0 * inv + 128) >> 8);
        i1 = t1 >= 0 ? 2 * n + t1 : 2 * n - ((t1 * inv + 128) >> 8);
      } else {
        i0 = t0 >= 0 ? 2 * n - t0 : 2 * n + ((t0 * inv + 128) >> 8);
        i1 = t1 >= 0 ? 2 * n - t1 : 2 * n + ((t1 * inv + 128) >> 8);
      }
      v = ((32 - ff) * r[i0] + ff * r[i1] + 16) >> 5;
      if (edge && mode == 26 && x == 0)
        v = min(max(su[2 * n + 1] + ((su[2 * n - 1 - y] - su[2 * n]) >> 1),
                    0), maxv);
      if (edge && mode == 10 && y == 0)
        v = min(max(su[2 * n - 1] + ((su[2 * n + 1 + x] - su[2 * n]) >> 1),
                    0), maxv);
    }
    out[(long long)b * total + e] = v;
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
