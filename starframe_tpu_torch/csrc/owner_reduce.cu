// Owner reductions of the tile engine's compound rows: a body with several
// colliders has one row each, contiguous in the tile layout and sharing the
// owner id `ob`. Once a substep the project phase's row sums (dxx, dxy, dth,
// cnt) become per-body sums on every sibling row (`owner_sum`), and after
// the apply phase the velocity pass's raw sums are owner-summed, normalised
// by the body's count and damped (`owner_velocity`). With CCD the TOI
// factors of a body's rows become their minimum on every sibling row
// (`owner_min`), so the whole body advances by its earliest sibling's clamp.
//
// Replaces starframe_tpu/pallas/tiles.py `_owner_shift_reduce` with `add`
// (`_owner_sum3`, and the velocity pass of `run_tiled_frame`, :2046-2054 and
// :2072-2086), which is XLA code, not a Pallas kernel: 2 * (kc - 1) masked
// rolls of the row axis. Each row here adds the same terms in the same
// order as the rolls do: itself, then rows i - 1, i + 1, i - 2, i + 2, ...
// up to kc - 1 away, wrapping around the ends as a roll does, a row of
// another owner adding +0. So a row's sum equals the plain twin's bitwise.
// `owner_min` replaces `_owner_min3` (the same rolls with `minimum` and a
// neutral +inf, tiles.py:1483, used at :2025-2027) the same way; a minimum
// is exact, so it is bitwise equal whatever the order.
//
// What bounds it on an H100: bytes. Each row reads its k + 1 words (k
// fields and its owner id) and writes k, ~0.7 MB for `owner_sum` at the
// compound pile's 20,224 rows (~0.2 us at 3.35 TB/s); the neighbours'
// words come from the same cache lines. One thread per row, 256 a block,
// no shared memory, no atomics; a launch costs far more than its bytes.
// The row bodies live in owner_rows.cuh: the compound whole-frame kernel
// (tile_compound_frame.cu) runs them between its grid barriers, so that a
// frame needs none of these launches.

#include "owner_rows.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) owner_min_kernel(OwnerSumArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  for (int q = 0; q < a.k; ++q)
    a.y[q][i] = owner_min_row(a.x[q], a.ob, i, a.n, a.kc);
}

__global__ void __launch_bounds__(kThreads) owner_sum_kernel(OwnerSumArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  for (int q = 0; q < a.k; ++q)
    a.y[q][i] = owner_sum_row(a.x[q], a.ob, i, a.n, a.kc);
}

__global__ void __launch_bounds__(kThreads)
    owner_velocity_kernel(OwnerVelocityArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < a.n) owner_velocity_row(a, i);
}

}  // namespace

SF_EXPORT(sf_owner_sum, OwnerSumArgs)
SF_EXPORT(sf_owner_velocity, OwnerVelocityArgs)
SF_EXPORT(sf_owner_min, OwnerSumArgs)

extern "C" int sf_owner_min(const OwnerSumArgs* a, void* stream) {
  if (a->k < 1 || a->k > 4 || a->kc < 1) return (int)cudaErrorInvalidValue;
  if (a->n > 0)
    owner_min_kernel<<<(a->n + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int sf_owner_sum(const OwnerSumArgs* a, void* stream) {
  if (a->k < 1 || a->k > 4 || a->kc < 1) return (int)cudaErrorInvalidValue;
  if (a->n > 0)
    owner_sum_kernel<<<(a->n + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int sf_owner_velocity(const OwnerVelocityArgs* a, void* stream) {
  if (a->kc < 1) return (int)cudaErrorInvalidValue;
  if (a->n > 0)
    owner_velocity_kernel<<<(a->n + kThreads - 1) / kThreads, kThreads, 0,
                            (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
