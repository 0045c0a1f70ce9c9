// Static pair-eligibility mask for the slot-table broadphase.
//
// Replaces starframe_tpu/pallas/slots.py `_elig_kernel` (launched by
// `build_elig_mask`). Output elig[w, j, i] (int8) says whether partner
// collider j may ever enter collider i's slot row: different bodies, each
// one's layer bit set in the other's mask, both active, the own row
// responds to impulses (or is a moving sensor), and the pair moves or holds
// a sensor.
//
// What bounds it on an H100: the store. At W = 4096, M = 256 the mask is
// 268 MB, written once per rollout; the inputs are 7 small [W, M] / [W, N]
// rows that stay in L1/L2. Design: one thread per output byte, neighbouring
// threads on neighbouring i, so a warp writes 32 contiguous bytes and the
// j-side loads are warp-uniform broadcasts. A single pass, no shared memory.

#include "common.cuh"

namespace {

// Arithmetic right shift with XLA's (and PyTorch's) out-of-range rule: a
// shift by 32 or more (or negative) leaves only the sign.
__device__ __forceinline__ int shr(int x, int s) {
  return (s < 0 || s > 31) ? (x < 0 ? -1 : 0) : (x >> s);
}

__global__ void elig_kernel(EligArgs a) {
  const long long M = a.M;
  const long long total = (long long)a.W * M * M;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int i = (int)(idx % M);
    const int j = (int)((idx / M) % M);
    const long long w = idx / (M * M);
    const long long ri = w * M + i, rj = w * M + j;
    const int cbi = a.cbody[ri], cbj = a.cbody[rj];
    const float resp_i = a.responds[w * a.N + cbi];
    const float mov_i = a.moves[w * a.N + cbi];
    const float mov_j = a.moves[w * a.N + cbj];
    const int li = a.layer[ri], lj = a.layer[rj];
    const int mi = a.lmask[ri], mj = a.lmask[rj];
    const bool diff_body = cbi != cbj;
    const bool layer_ok = ((shr(mi, lj) & 1) & (shr(mj, li) & 1)) != 0;
    const bool both_active = a.active[ri] > 0.f && a.active[rj] > 0.f;
    const bool sens_i = a.sensor[ri] > 0.f, sens_j = a.sensor[rj] > 0.f;
    const bool row_ok = resp_i > 0.f || (sens_i && mov_i > 0.f);
    const bool pair_moves = mov_i > 0.f || mov_j > 0.f;
    a.elig[idx] = (int8_t)(diff_body && layer_ok && both_active && row_ok &&
                           (pair_moves || sens_i || sens_j));
  }
}

}  // namespace

SF_EXPORT(sf_elig, EligArgs)

extern "C" int sf_elig(const EligArgs* a, void* stream) {
  const long long total = (long long)a->W * a->M * a->M;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;  // grid-stride beyond this
  if (blocks > 0)
    elig_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// An error code's text, for the wrappers' messages (hopper/_build.py).
extern "C" const char* sf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
