// The batched frame kernel's instances of a ranked table (frame2.cuh:
// only the rows that may hold a slot keep records), which frame2.cu hands
// the launches it places so; compiled beside it.

#include "frame2.cuh"

int frame2_launch_ranked(const Frame2Args& a, cudaStream_t stream) {
  return launch_as<true>(a, place_of(a), stream);
}

int frame2_blocks_ranked(int V, int J, int ccd, int N, int M, int Csol,
                         int Rs) {
  return blocks_as<true>(V, J > 0, ccd != 0, place(N, M, V, J, Csol, Rs));
}
