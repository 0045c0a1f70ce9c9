// The batched frame kernel's launches and layout (the kernel and its
// notes: frame2.cuh): the instances of an every-row table here, those of a
// ranked one in frame2_ranked.cu.

#include "frame2.cuh"

SF_EXPORT(sf_frame2, Frame2Args)

extern "C" int sf_frame2_fields() { return F2_FIELDS; }

extern "C" int sf_frame2_slot_bytes() { return F2_SLOT_BYTES; }

// The layout of a launch at these shapes (`place`; Rs: the most rows of a
// world that may hold a slot, M where every row may), for the wrapper's
// mirror.
extern "C" long long sf_frame2_shared_bytes(int N, int M, int V, int J,
                                            int Csol, int Rs) {
  return (long long)place(N, M, V, J, Csol, Rs).bytes;
}

extern "C" int sf_frame2_table_rows(int N, int M, int V, int J, int Csol,
                                    int Rs) {
  return place(N, M, V, J, Csol, Rs).R;
}

// The rows the launch's table holds: M, or Rs where they are ranked.
extern "C" int sf_frame2_table_size(int N, int M, int V, int J, int Csol,
                                    int Rs) {
  return place(N, M, V, J, Csol, Rs).rows;
}

// Bytes of a world's global scratch the launch needs (0: none).
extern "C" long long sf_frame2_scratch_bytes(int N, int M, int V, int J,
                                             int Csol, int Rs) {
  const Placement pl = place(N, M, V, J, Csol, Rs);
  return all_shared(pl, J) ? 0 : (long long)scratch_bytes(N, M, Csol, J);
}

// Whether the joint list of a launch at these shapes sits in shared memory.
extern "C" int sf_frame2_joints_shared(int N, int M, int V, int J, int Csol,
                                       int Rs) {
  return J > 0 && place(N, M, V, J, Csol, Rs).jat > 0 ? 1 : 0;
}

extern "C" int sf_frame2_block_threads(int N, int M, int V, int J, int Csol,
                                       int Rs) {
  return block_threads(place(N, M, V, J, Csol, Rs).bytes);
}

extern "C" int sf_frame2_blocks_per_sm(int V, int J, int ccd, int N, int M,
                                       int Csol, int Rs) {
  const Placement pl = place(N, M, V, J, Csol, Rs);
  if (pl.R < 0) return -1;
  if (pl.ranked) return frame2_blocks_ranked(V, J, ccd, N, M, Csol, Rs);
  return blocks_as<false>(V, J > 0, ccd != 0, pl);
}

extern "C" int sf_frame2(const Frame2Args* a, void* stream) {
  // the wrapper pads vertex rows (repeating v0, which leaves every min, max
  // and manifold unchanged) to one of the compiled widths
  const int Csol = a->Cs > 0 ? a->Cs : a->C;
  const Placement pl = place_of(*a);
  // a shape the wrapper cannot place, or a global table, scratch or row
  // flags it did not give
  if (pl.R < 0 || (pl.R < pl.rows && a->gtab == nullptr) ||
      (pl.ranked && (a->slot_rows == nullptr || pl.R < pl.rows)) ||
      (!all_shared(pl, a->J) && a->gscratch == nullptr) ||
      (a->ccd && a->Cs > 0 && a->side == nullptr) ||
      (unsigned long long)Csol * a->M * a->M > (1ull << 32))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (pl.ranked) return frame2_launch_ranked(*a, st);
  return launch_as<false>(*a, pl, st);
}
