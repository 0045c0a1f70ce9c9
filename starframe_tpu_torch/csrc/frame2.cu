// One batched XPBD frame: frame-start contact manifolds for every slot,
// then `substeps` x [integrate -> `iterations` x Jacobi contact projection
// -> velocity reconstruction -> restitution/friction velocity pass].
//
// Replaces starframe_tpu/pallas/frame2.py `_frame2_kernel` (launched by
// `run_frame2`) in every configuration it has: contact-only or with joints
// (both joint tiers), with or without CCD, with one collider->body list for
// the batch or one per world, and with or without per-frame solve-slot
// compaction (Cs, `rank_row` below). Sleep needs no kernel change: the
// wrapper's caller zeroes a sleeper's inverse masses for the frame.
//
// What bounds it on an H100: latency. The slot table, everything a row's
// slots carry through the frame, lives in shared memory. Of the ~30 floats
// a slot once kept in a 1.0 GB global scratch (W = 4096, C = 8, M = 256),
// only what cannot be recomputed is stored: the body-local normal and
// anchors, the two lambdas, the four terms a pass adds to the row's sums,
// the partner collider (int16) and a mask byte, 67 bytes a slot
// (common.cuh Frame2Field). The pair's friction, restitution and the
// partner's inverse masses are read from the world's state where they are
// used, and the static-friction reference (the anchors at the substep's
// start, and CCD's frame-start normal) is rebuilt from four [N] planes of
// the substep-start pose with the expressions that once wrote it, so the
// frame is bitwise what it was. At the main path's shapes the table is 137
// KB and the block 182 KB: one 512-thread block an SM, 128 registers a
// thread, and what is left is the dependent chain of each slot's solve
// (its divisions and square roots) and the barriers between phases. A
// shape whose table does not fit keeps rows i >= R (`place`) in a global
// table of the same layout, reached through the same row accessor
// (`row_of`); one whose pose planes do not fit either keeps them in global
// memory too. The manifold math itself is scalar SAT/clip code, ~1-2k
// flops per active slot.
//
// Design: one CTA per world, 512 threads (256 where two blocks fit an
// SM's shared memory: `block_threads`). A thread is body n in the body
// phases, one (row i, slot c) item in the manifold set-up, one live item
// in the slot phases (the projection, the velocity pass), one joint item
// in the joint phases (kJ, below), and row i where a row's slots go
// together (compaction's ranking, CCD's TOI), strided when the block runs
// out. Body state, the world's collider geometry and
// the slot table live in shared memory. The Jacobi semantics are the TPU's: every slot reads
// the iteration's start pose and leaves its terms in its record,
// __syncthreads(), and only then does each body sum them and apply the
// count-normalised, clipped corrections. A body sums its colliders' rows in
// ascending collider order from a CSR, world 0's for a batch of one
// topology (what the TPU's one-hot dot computes; colliders inactive in
// every world, whose rows are empty, left out) or each world's own (the
// TPU's per-world owner tables, summed k = 0..Kc-1), and each row's slots
// in order c = 0..C-1 (frame2.py `_sum_w`), so the adds are the
// reference's, in its order. No float atomics: the frame is bitwise
// reproducible. Slots whose manifold has no active point are skipped;
// they contribute exact zeros in the reference. The live set says which:
// after the set-up the block compacts the items u = c * M + i whose
// manifold has an active point (F2_PM0 | F2_PM1; no later phase changes
// those bits) into a list in ascending u, with warp ballots and the warps'
// counts summed in warp order, and a bit set of each row's live slots.
// The projection and the velocity pass walk the list, so no warp issues
// an empty slot's item (58% of the main path's slots); the body sums walk
// each row's bits in ascending c. It takes the shared memory of planes only
// the set-up reads (`dead_words`), so the block's bytes are the parent's;
// a table too wide for them (V = 4 from Csol = 28) keeps it in global
// memory beside the pose planes. Each phase that moves an
// angle refreshes its cos/sin, and body phases with no slot phase between
// them share a loop, so a substep has four barriers: after the integrate,
// after the projection, after the apply, after the velocity pass. The
// static-friction reference is the reference's carried velocity-pass
// kinematics (kin00 at the first substep): the anchors at the pose that
// ended the previous substep, which the pose planes hold. The manifold
// and the per-point contact solves are the shared transcriptions of
// kernels.py in contact.cuh, over the V (templated) vertices.
//
// Joints (the kJ instantiation; the contact-only one compiles without any
// of it, so the main path keeps its registers and occupancy): the world's
// joint parameters (15 fields x J) live in shared memory. After the live
// set the block lists the frame's live joint items once, the joint list:
// each body n's slots jc with jact != 0 (joint_slots.cu), n-major and in
// ascending jc, each a record of the slot read canonicalised so that n is
// endpoint A (frame2.py `jd_all`) and of the four terms a pass leaves, and
// each body's first item (`jstart`). At most 2J items (a joint is in at
// most its two bodies' slots), in the shared memory past the slot table
// where they fit and cost no second block an SM, else in the world's
// global scratch (`place`). The joint
// phases walk the list, one item a thread, and read no slot table; each
// body then sums the terms of its items that the pass took, in ascending
// jc from 0, which are the adds the reference makes in its order. The
// Jacobi tier solves the items during the contact slot phase (every body
// reads the iteration-start pose) and adds a body's sum after the contact
// sum, as the reference does. The coloured Gauss-Seidel tier runs one pass
// per colour after the contact apply: each pass solves that colour's items
// at the pass-start pose, __syncthreads(), applies, so same-colour joints
// (which share no dynamic body) apply exactly; the last pass takes every
// colour >= its own. A body that no item of the pass reaches skips the
// divisions of its empty sum (their quotients are +0) and, like any body
// whose angle keeps its bits, the refresh of its cos/sin. Motors and joint
// damping join the velocity pass the same way as the Jacobi sum.
//
// CCD (the kCcd instantiation, frame2.py:464-514, 621-631): after the
// integrate phase a row phase takes each bullet-owned row's TOI factor,
// the min over its slots' solved points of the fraction of the substep's
// closing along the frame-start normal that lands the pair at ccd_slop of
// penetration (anchors at the substep-start pose, carried like the
// static-friction reference, and at the integrated one); then a body phase
// sums (1 - f) over the body's colliders (the same owner lists as the row
// sums) and pulls the integrated pose back to p0 + f (p - p0) where f < 1.
// The substep-start pose waits in dxx/dxy/dth (zeroed after the clamp), and
// the TOI's anchors and normal at it are rebuilt from the pose planes like
// the static-friction reference.

#include "common.cuh"
#include "contact.cuh"

namespace {

constexpr int kThreads = 512;  // a block's threads, or half (block_threads)
constexpr size_t kSmPerSM = 233472;  // shared memory an H100 SM shares out
constexpr size_t kSmReserved = 1024;  // of it, what the runtime keeps a block
constexpr float kPi = 3.14159265358979323846f;  // pi and 2 pi rounded to f32
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr int kJointFields = 15;  // Frame2Args jtype .. jcolor
constexpr int kMaxC = 32;  // table width rank_row ranks (MAX_COMPACT_C)
enum JointType { kDistance = 1, kPin = 2, kAngleRange = 3, kMotor = 4,
                 kWeld = 5 };  // state.py JOINT_*

struct Shared {
  // body state [N]
  float *px, *py, *an, *vx, *vy, *om, *invm, *invi, *dyn, *kin;
  float *vtx, *vty, *vtom, *cab, *sab, *dxx, *dxy, *dth, *spd;
  // collider geometry [M] (verts [V, M]) and a [4, M] row plane (CCD's
  // per-row TOI terms in its first [M]); from row's second [M] to the end
  // of nv, only the set-up reads (`dead_words`)
  float *fric, *rest, *row, *vlx, *vly, *rad, *sens, *ext;
  int *nv, *cbody, *ostart, *oidx;
  // joints (kJ only): parameters [J], then [4, N] words (`shared_bytes`)
  // that begin with each body's first item in the joint list [N + 1]
  int *jty, *jba, *jbb, *jcol;
  float *jaax, *jaay, *jabx, *jaby, *jrest, *jlo, *jhi, *jcomp, *jdamp;
  float *jms, *jmm;
  int* jstart;
};

__host__ __device__ inline size_t shared_bytes(int N, int M, int V, int J) {
  // body: 19 [N] planes; colliders: verts 2 [V, M], five [M] fields and the
  // [4, M] row plane; ints: cbody, nverts, owner_idx [M] and owner_start;
  // with joints: 15 [J] parameter rows and 4 [N] words, of which the joint
  // list's starts take N + 1: a jointed batch's eligibility and R follow
  // these bytes (frame2.py `frame2_state_bytes`), which test_torch_frame2.py
  // `test_eligibility_follows_the_world_state_only` pins
  return (size_t)(19 * N + (2 * V + 9) * M) * sizeof(float) +
         (size_t)(3 * M + N + 1) * sizeof(int) +
         (J > 0 ? (size_t)(kJointFields * J + 4 * N) * sizeof(float) : 0);
}

template <bool kJ>
__device__ Shared carve(float* base, int N, int M, int V, int J) {
  Shared s;
  float* p = base;
  float** bodyf[] = {&s.px,  &s.py,  &s.an,   &s.vx,  &s.vy,  &s.om,  &s.invm,
                     &s.invi, &s.dyn, &s.kin,  &s.vtx, &s.vty, &s.vtom, &s.cab,
                     &s.sab, &s.dxx, &s.dxy,  &s.dth, &s.spd};
  for (float** f : bodyf) {
    *f = p;
    p += N;
  }
  s.fric = p; p += M;
  s.rest = p; p += M;
  s.row = p; p += 4 * M;
  s.vlx = p; p += V * M;
  s.vly = p; p += V * M;
  s.rad = p; p += M;
  s.sens = p; p += M;
  s.ext = p; p += M;
  int* q = reinterpret_cast<int*>(p);
  s.nv = q; q += M;
  s.cbody = q; q += M;
  s.oidx = q; q += M;
  s.ostart = q; q += N + 1;
  if constexpr (kJ) {
    int** ji[] = {&s.jty, &s.jba, &s.jbb, &s.jcol};
    for (int** f : ji) {
      *f = q;
      q += J;
    }
    float* r = reinterpret_cast<float*>(q);
    float** jf[] = {&s.jaax, &s.jaay, &s.jabx, &s.jaby, &s.jrest, &s.jlo,
                    &s.jhi,  &s.jcomp, &s.jdamp, &s.jms, &s.jmm};
    for (float** f : jf) {
      *f = r;
      r += J;
    }
    s.jstart = reinterpret_cast<int*>(r);
  }
  return s;
}

// Words of the world's state that only the set-up reads: the row plane
// past CCD's [M], the vertex planes, rad, sens, ext and nv, contiguous
// (`carve`). The live set takes them after the set-up where it fits.
__host__ __device__ inline size_t dead_words(int M, int V) {
  return (size_t)(2 * V + 7) * M;
}

// The live set of a Csol-slot table over M rows (see the header note):
// the build's warp counts (two rounds of up to 32 warps), the row bits
// [live_words, M], then one entry per item, uint16 where every u fits.
constexpr int kLiveCounts = 64;
__host__ __device__ inline int live_words(int Csol) { return (Csol + 31) / 32; }
__host__ __device__ inline bool live_wide(int M, int Csol) {
  return (size_t)Csol * M > 65536;
}
__host__ __device__ inline size_t live_bytes(int M, int Csol) {
  const size_t items = (size_t)Csol * M;
  return (size_t)4 * (kLiveCounts + live_words(Csol) * M) +
         items * (live_wide(M, Csol) ? 4 : 2);
}

// The joint list of J joints (see the header note): the build's warp
// counts, then kJointWords [2J] planes, a record a column: own body, type,
// partner body, colour (int); act, own and partner anchors, rest, lo, hi,
// compliance, damping, motor speed and budget (JointSlot's values); the
// four terms a pass leaves.
constexpr int kJointWords = 20;
__host__ __device__ inline size_t joint_bytes(int J) {
  return J > 0 ? (size_t)4 * (kLiveCounts + (size_t)kJointWords * 2 * J) : 0;
}

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) / 16 * 16;
}

// A world's global scratch, for the joint list, the pose planes and the
// live set where they do not fit in shared memory (each at its own offset:
// the joint list first, then the pose planes at joint_bytes(J)).
__host__ __device__ inline size_t scratch_bytes(int N, int M, int Csol,
                                                int J) {
  return joint_bytes(J) + align16((size_t)4 * N * sizeof(float) +
                                  live_bytes(M, Csol));
}

// Where a world's slot table goes (see the header note): the shared
// memory left after the world's state holds the four [N] substep-start pose
// planes, then the records of rows i < R. R = -1 when the state alone does
// not fit (the wrapper refuses such a shape); R = 0 with `pose_shared`
// false when the pose planes do not fit either. `live_shared`: the live
// set fits in the set-up's planes (`dead_words`), else it goes to global
// memory beside the pose planes. `jat`: the joint list's offset in shared
// memory (`joints_at`), or 0 where it goes to the global scratch too (or
// there are no joints).
struct Placement {
  int R;
  unsigned jat;
  bool pose_shared, live_shared;
  size_t bytes;  // the block's dynamic shared memory
};

// Whether the pose planes, the live set and (J > 0) the joint list all sit
// in shared memory: else the launch needs the world's global scratch
// (`scratch_bytes`).
__host__ __device__ inline bool all_shared(const Placement& pl, int J) {
  return pl.pose_shared && pl.live_shared && (J == 0 || pl.jat > 0);
}

// Whether two blocks of `bytes` of dynamic shared memory fit an SM
// (`block_threads`).
__host__ __device__ inline bool two_blocks(size_t bytes) {
  return 2 * (bytes + kSmReserved) <= kSmPerSM;
}

// The offset of J joints' list in shared memory, past a table that ends at
// byte `end`, 16-aligned: so it takes no row from R. 0 (global memory)
// where it does not fit there, or where it would cost the block its second
// block an SM (`block_threads`).
__host__ __device__ inline size_t joints_at(size_t end, int J) {
  const size_t at = align16(end), top = at + joint_bytes(J);
  return J > 0 && top <= F2_SHARED_LIMIT && two_blocks(top) == two_blocks(end)
             ? at
             : 0;
}

__host__ __device__ inline Placement place(int N, int M, int V, int J,
                                           int Csol) {
  const size_t state = shared_bytes(N, M, V, J);
  const size_t pose = (size_t)4 * N * sizeof(float);
  const bool live_shared = live_bytes(M, Csol) <= 4 * dead_words(M, V);
  if (state > F2_SHARED_LIMIT) return {-1, 0u, false, false, state};
  if (state + pose > F2_SHARED_LIMIT) return {0, 0u, false, live_shared, state};
  const size_t per_row = (size_t)Csol * F2_SLOT_BYTES;
  const size_t fit = (F2_SHARED_LIMIT - state - pose) / per_row;
  const int R = fit < (size_t)M ? (int)fit : M;
  const size_t end = state + pose + per_row * R, jat = joints_at(end, J);
  return {R, (unsigned)jat, true, live_shared,
          jat > 0 ? jat + joint_bytes(J) : end};
}

// Threads a block: kThreads, or half as many where two such blocks fit an
// SM's shared memory (a small world, e.g. 128 bodies: two worlds an SM,
// each running while the other waits at a barrier or fills only 128
// threads in a body phase; two 256-thread blocks also fit the registers).
inline int block_threads(size_t bytes) {
  return two_blocks(bytes) ? kThreads / 2 : kThreads;
}

// Bytes of one world's global table of K slots x Rn rows (16-aligned).
__host__ __device__ inline size_t table_bytes(int K, int Rn) {
  return ((size_t)K * Rn * F2_SLOT_BYTES + 15) / 16 * 16;
}

// Row r of a table of K slots x Rn rows at `base` (shared or global: the
// accessors use generic addresses): field q of slot c at f[q * fs + c *
// cs], its partner collider at pc[c * cs], its mask byte at mk[c * cs].
struct SlotRow {
  float* f;
  int16_t* pc;
  uint8_t* mk;
  int cs, fs;
  __device__ __forceinline__ float& at(int q, int c) const {
    return f[q * fs + c * cs];
  }
  __device__ __forceinline__ int16_t& partner(int c) const {
    return pc[c * cs];
  }
  __device__ __forceinline__ uint8_t& mask(int c) const { return mk[c * cs]; }
};

__device__ __forceinline__ SlotRow table_row(uint8_t* base, int K, int Rn,
                                             int r) {
  float* f = reinterpret_cast<float*>(base);
  int16_t* pc = reinterpret_cast<int16_t*>(f + F2_FIELDS * K * Rn);
  uint8_t* mk = reinterpret_cast<uint8_t*>(pc + K * Rn);
  return {f + r, pc + r, mk + r, Rn, K * Rn};
}

// One joint slot of body n, canonicalised so that n is endpoint A: the
// partner body, the anchors swapped, weld rest and motor speed negated and
// an angle range's bounds swapped and negated when n is endpoint B.
struct JointSlot {
  int ty, pb, color;
  float act, oax, oay, pax, pay, rest, lo, hi, comp, damp, ms, mm;
};

__device__ __forceinline__ JointSlot joint_slot(const Shared& s,
                                                const Frame2Args& a,
                                                long long w, int jc, int n) {
  const long long o = (w * a.JC + jc) * a.N + n;
  const int js = a.jslot[o];
  const bool own_a = a.jside[o] > 0.f;
  JointSlot j;
  j.act = a.jact[o];
  j.ty = s.jty[js];
  j.pb = own_a ? s.jbb[js] : s.jba[js];
  j.color = s.jcol[js];
  const float aax = s.jaax[js], aay = s.jaay[js];
  const float abx = s.jabx[js], aby = s.jaby[js];
  j.oax = own_a ? aax : abx;
  j.oay = own_a ? aay : aby;
  j.pax = own_a ? abx : aax;
  j.pay = own_a ? aby : aay;
  const float rest = s.jrest[js], lo = s.jlo[js], hi = s.jhi[js];
  const float ms = s.jms[js];
  const bool keep_rng = own_a || j.ty != kAngleRange;
  j.rest = own_a ? rest : -rest;
  j.lo = keep_rng ? lo : -hi;
  j.hi = keep_rng ? hi : -lo;
  j.comp = s.jcomp[js];
  j.damp = s.jdamp[js];
  j.ms = own_a ? ms : -ms;
  j.mm = s.jmm[js];
  return j;
}

// world anchors of both ends; offsets from own (ra) and partner (rb) body
__device__ __forceinline__ void joint_arms(const Shared& s, int n,
                                           const JointSlot& j, float& wax,
                                           float& way, float& wbx, float& wby,
                                           float& rax, float& ray, float& rbx,
                                           float& rby) {
  const float pax = s.px[n], pay = s.py[n], ca = s.cab[n], sa = s.sab[n];
  const float pbx = s.px[j.pb], pby = s.py[j.pb];
  const float cb = s.cab[j.pb], sb = s.sab[j.pb];
  wax = pax + ca * j.oax - sa * j.oay;
  way = pay + sa * j.oax + ca * j.oay;
  wbx = pbx + cb * j.pax - sb * j.pay;
  wby = pby + sb * j.pax + cb * j.pay;
  rax = wax - pax;
  ray = way - pay;
  rbx = wbx - pbx;
  rby = wby - pby;
}

__device__ __forceinline__ float wrap_pi(float x) {
  return x - kTwoPi * floorf((x + kPi) / kTwoPi);
}

// kernels.solve_joints_b for one slot: own-side (dx, dy, dang, count)
__device__ __forceinline__ void solve_joint(const Shared& s, int n,
                                            const JointSlot& j, float active,
                                            float hh, float (&out)[4]) {
  float wax, way, wbx, wby, rax, ray, rbx, rby;
  joint_arms(s, n, j, wax, way, wbx, wby, rax, ray, rbx, rby);
  const float im_o = s.invm[n], ii_o = s.invi[n];
  const float im_p = s.invm[j.pb], ii_p = s.invi[j.pb];
  const float dx = wbx - wax, dy = wby - way;
  const float d = sqrtf(dx * dx + dy * dy);
  const float inv_d = 1.f / fmaxf(d, kEps);
  const float nx = dx * inv_d, ny = dy * inv_d;
  const bool is_dist = j.ty == kDistance;
  const bool is_point = j.ty == kPin || j.ty == kWeld;
  const float lo = is_point ? 0.f : j.lo, hi = is_point ? 0.f : j.hi;
  const float c_lin = d > hi ? d - hi : (d < lo ? d - lo : 0.f);
  const bool lin_active = (is_dist || is_point) && fabsf(c_lin) > 0.f &&
                          d > kEps && active > 0.f;
  const float cr_a = rax * ny - ray * nx;
  const float cr_b = rbx * ny - rby * nx;
  const float w_a = im_o + ii_o * cr_a * cr_a;
  const float w_b = im_p + ii_p * cr_b * cr_b;
  const float alpha_t = j.comp / hh;
  const float den = w_a + w_b + alpha_t;
  const float dlam =
      (lin_active && den > kEps) ? -c_lin / fmaxf(den, kEps) : 0.f;
  const float p_x = dlam * nx, p_y = dlam * ny;
  // angular rows: weld locks the relative angle, a range limits it
  const float phi = wrap_pi(s.an[j.pb] - s.an[n] - j.rest);
  const bool is_weld = j.ty == kWeld, is_rng = j.ty == kAngleRange;
  const float c_ang = is_weld     ? phi
                      : phi > j.hi ? phi - j.hi
                      : phi < j.lo ? phi - j.lo
                                   : 0.f;
  const bool ang_active =
      (is_weld || is_rng) && fabsf(c_ang) > 0.f && active > 0.f;
  const float den_a = ii_o + ii_p + alpha_t;
  const float dlam_ang =
      (ang_active && den_a > kEps) ? -c_ang / fmaxf(den_a, kEps) : 0.f;
  out[0] = -p_x * im_o;
  out[1] = -p_y * im_o;
  out[2] = -ii_o * (rax * p_y - ray * p_x) - dlam_ang * ii_o;
  out[3] = (lin_active ? 1.f : 0.f) + (ang_active ? 1.f : 0.f);
}

// kernels.velocity_joints_b for one slot: motor and joint damping
__device__ __forceinline__ void velocity_joint(const Shared& s, int n,
                                               const JointSlot& j, float h,
                                               float (&out)[4]) {
  float wax, way, wbx, wby, rax, ray, rbx, rby;
  joint_arms(s, n, j, wax, way, wbx, wby, rax, ray, rbx, rby);
  const float im_o = s.invm[n], ii_o = s.invi[n];
  const float im_p = s.invm[j.pb], ii_p = s.invi[j.pb];
  const float oa = s.om[n], ob = s.om[j.pb];
  const bool is_motor = j.ty == kMotor && j.act > 0.f;
  const float err = j.ms - (ob - oa);
  const float w_ang = ii_o + ii_p;
  float lam_m = w_ang > kEps ? err / fmaxf(w_ang, kEps) : 0.f;
  lam_m = fminf(fmaxf(lam_m, -j.mm * h), j.mm * h);
  lam_m = is_motor ? lam_m : 0.f;
  const bool damped = j.act > 0.f && j.damp > 0.f;
  const float relx = (s.vx[j.pb] - ob * rby) - (s.vx[n] - oa * ray);
  const float rely = (s.vy[j.pb] + ob * rbx) - (s.vy[n] + oa * rax);
  const float w_lin = im_o + im_p;
  const float damp_f = fminf(j.damp * h, 1.f);
  const float scale = w_lin > kEps ? damp_f / fmaxf(w_lin, kEps) : 0.f;
  const float p_dx = damped ? -relx * scale : 0.f;
  const float p_dy = damped ? -rely * scale : 0.f;
  out[0] = -p_dx * im_o;
  out[1] = -p_dy * im_o;
  out[2] = -lam_m * ii_o - ii_o * (rax * p_dy - ray * p_dx);
  out[3] = (is_motor || damped) ? 1.f : 0.f;
}

// The joint list (shared or global: generic addresses), K = 2J records
// (`joint_bytes`): word q of record k at w[q * K + k].
struct JointList {
  int* w;
  int K;
  __device__ __forceinline__ int& at(int q, int k) const {
    return w[q * K + k];
  }
  __device__ __forceinline__ float& f(int q, int k) const {
    return reinterpret_cast<float&>(w[q * K + k]);
  }
  __device__ __forceinline__ int body(int k) const { return at(0, k); }
  __device__ __forceinline__ int color(int k) const { return at(3, k); }
  __device__ __forceinline__ float& term(int q, int k) const {
    return f(16 + q, k);
  }
  __device__ __forceinline__ void store(int k, int n,
                                        const JointSlot& j) const {
    at(0, k) = n; at(1, k) = j.ty; at(2, k) = j.pb; at(3, k) = j.color;
    f(4, k) = j.act; f(5, k) = j.oax; f(6, k) = j.oay; f(7, k) = j.pax;
    f(8, k) = j.pay; f(9, k) = j.rest; f(10, k) = j.lo; f(11, k) = j.hi;
    f(12, k) = j.comp; f(13, k) = j.damp; f(14, k) = j.ms;
    f(15, k) = j.mm;
  }
  __device__ __forceinline__ JointSlot slot(int k) const {
    JointSlot j;
    j.ty = at(1, k); j.pb = at(2, k); j.color = at(3, k);
    j.act = f(4, k); j.oax = f(5, k); j.oay = f(6, k); j.pax = f(7, k);
    j.pay = f(8, k); j.rest = f(9, k); j.lo = f(10, k); j.hi = f(11, k);
    j.comp = f(12, k); j.damp = f(13, k); j.ms = f(14, k);
    j.mm = f(15, k);
    return j;
  }
};

// Whether a pass of colour `color` (< 0: every joint; `last`: >= it)
// takes an item of colour c.
__device__ __forceinline__ bool takes(int c, int color, bool last) {
  return color < 0 || (last ? c >= color : c == color);
}

// One pass over the joint list's items (s.jstart[N] of them) this thread
// takes (strided by the block), each that the pass takes leaving its terms
// in its record
// (frame2.py `sum_j`'s operands): position rows (kVel false) or velocity
// rows. A slot that is empty or filtered out adds exact zeros in the
// reference, so it has no item or is skipped here.
template <bool kVel>
__device__ __forceinline__ void joint_pass(const Shared& s,
                                           const Frame2Args& a,
                                           const JointList& jl, int color,
                                           bool last) {
  for (int k = threadIdx.x; k < s.jstart[a.N]; k += blockDim.x) {
    if (!takes(jl.color(k), color, last)) continue;
    const JointSlot j = jl.slot(k);
    float v[4];
    if constexpr (kVel)
      velocity_joint(s, jl.body(k), j, a.h, v);
    else
      solve_joint(s, jl.body(k), j, j.act, a.hh, v);
#pragma unroll
    for (int q = 0; q < 4; ++q) jl.term(q, k) = v[q];
  }
}

// Body n's sum of the terms its items of the pass left (frame2.py
// `sum_j`), in ascending jc from 0; false when the pass took none of them
// (every sum +0).
__device__ __forceinline__ bool joint_terms(const Shared& s,
                                            const JointList& jl, int n,
                                            int color, bool last,
                                            float (&acc)[4]) {
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
  bool any = false;
  for (int k = s.jstart[n]; k < s.jstart[n + 1]; ++k) {
    if (!takes(jl.color(k), color, last)) continue;
    any = true;
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += jl.term(q, k);
  }
  return any;
}

// Run f(i, c) on the (row i, slot c) items of a K-slot table over M rows
// that this thread takes: items u = c * M + i, strided by the block, so
// consecutive threads take consecutive rows.
template <class F>
__device__ __forceinline__ void for_items(int K, int M, F f) {
  const int di = blockDim.x % M, dc = blockDim.x / M;
  int i = threadIdx.x % M, c = threadIdx.x / M;
  while (c < K) {
    f(i, c);
    i += di;
    c += dc;
    if (i >= M) {
      i -= M;
      ++c;
    }
  }
}

// The live set as the slot phases read it: the row bits [words, M] and
// the list of n items u = c * M + i, ascending. c = u / M is a
// multiply-high by mdiv = ceil(2^32 / M), exact for u < 2^32 / M (the
// launch refuses Csol * M * M > 2^32).
struct LiveSet {
  uint32_t* bits;
  void* list;
  int n;
  bool wide;  // uint32 entries, else uint16
  unsigned mdiv;
};

// Run f(i, c) on the live items of set L over M rows that this thread
// takes: list entries strided by the block, so consecutive threads take
// consecutive live items (mostly consecutive rows of one slot).
template <class F>
__device__ __forceinline__ void for_live(const LiveSet& L, int M, F f) {
  for (int k = threadIdx.x; k < L.n; k += blockDim.x) {
    const unsigned u = L.wide ? static_cast<const uint32_t*>(L.list)[k]
                              : static_cast<const uint16_t*>(L.list)[k];
    const int c = M > 1 ? (int)__umulhi(u, L.mdiv) : (int)u;
    f((int)u - c * M, c);
  }
}

// The substep-start pose [N] (x, y, cos, sin): the pose that ended the
// previous substep (the frame-start pose at the first). The load and the
// velocity reconstruction fill it; the static-friction reference and the
// TOI's substep-start anchors and normal are rebuilt from it.
struct Pose0 {
  float *x, *y, *c, *s;
};

// A slot's frame-start constants (frame2.py `cb_`): what its record stores,
// and the smallest active separation that compaction ranks by.
struct SlotSetup {
  float n_ax, n_ay, a_ax[2], a_ay[2], b_ax[2], b_ay[2];
  float sep_min;
  int pc;
  int mask;
};

// The manifold of row i's slot against partner collider pc at the
// frame-start pose (own vertices vax/vay), with a velocity-expanded
// speculative margin, in body-local terms. Every mask is 0 or 1 (the
// manifold's pmask, K2's slot_act, the collider's sensor flag), so each
// is kept as a bit; `touched` starts at the slot's touch flag.
template <int V>
__device__ __forceinline__ void setup_slot(
    const Shared& s, const Frame2Args& a, int i, int pc, float act,
    const float (&vax)[V], const float (&vay)[V], float o_px, float o_py,
    float o_ca, float o_sa, float o_spd, SlotSetup& u) {
  const int M = a.M;
  const int pb = s.cbody[pc];
  const float p_px = s.px[pb], p_py = s.py[pb];
  const float p_ca = s.cab[pb], p_sa = s.sab[pb];
  const float p_spd = s.spd[pb] + fabsf(s.om[pb]) * s.ext[pc];
  float vbx[V], vby[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float x = s.vlx[v * M + pc], y = s.vly[v * M + pc];
    vbx[v] = p_px + p_ca * x - p_sa * y;
    vby[v] = p_py + p_sa * x + p_ca * y;
  }
  // velocity-expanded speculative margin: a contact that forms during
  // this frame's substeps must already be in the manifold
  const float margin_eff = a.margin + a.dt * (o_spd + p_spd);
  Manifold m;
  manifold<V>(vax, vay, s.nv[i], s.rad[i], vbx, vby, s.nv[pc], s.rad[pc],
              margin_eff, m);
  const float solvable = act * (1.f - fmaxf(s.sens[i], s.sens[pc]));
  u.n_ax = o_ca * m.nx + o_sa * m.ny;
  u.n_ay = -o_sa * m.nx + o_ca * m.ny;
  u.pc = pc;
  u.mask = 0;
  u.sep_min = 1e9f;
  float touch0 = 0.f;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const float dxa = m.wax[p] - o_px, dya = m.way[p] - o_py;
    u.a_ax[p] = o_ca * dxa + o_sa * dya;
    u.a_ay[p] = -o_sa * dxa + o_ca * dya;
    const float dxb = m.wbx[p] - p_px, dyb = m.wby[p] - p_py;
    u.b_ax[p] = p_ca * dxb + p_sa * dyb;
    u.b_ay[p] = -p_sa * dxb + p_ca * dyb;
    const float pm = m.pmask[p] * act;
    u.mask |= (pm != 0.f ? F2_PM0 : 0) << p;
    u.mask |= (pm * solvable > 0.f ? F2_SM0 : 0) << p;
    touch0 = fmaxf(touch0, (m.sep[p] < kTouchSlop ? 1.f : 0.f) * pm);
    if (pm > 0.f) u.sep_min = fminf(u.sep_min, m.sep[p]);
  }
  u.mask |= touch0 > 0.f ? F2_TOUCHED : 0;
}

// Slot c of table row t gets u's record, its lambdas zeroed.
__device__ __forceinline__ void store_slot(const SlotRow& t, int c,
                                           const SlotSetup& u) {
  t.at(F2_NAX, c) = u.n_ax;
  t.at(F2_NAY, c) = u.n_ay;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    t.at(F2_AAX0 + p, c) = u.a_ax[p];
    t.at(F2_AAY0 + p, c) = u.a_ay[p];
    t.at(F2_BAX0 + p, c) = u.b_ax[p];
    t.at(F2_BAY0 + p, c) = u.b_ay[p];
  }
  t.at(F2_LAM0, c) = 0.f;
  t.at(F2_LAM1, c) = 0.f;
  t.partner(c) = (int16_t)u.pc;
  t.mask(c) = (uint8_t)u.mask;
}

// The TOI minimum over the K slots of table row t (kCcd), for a row of
// bullet body ob (frame2.py:482-504): each solved point's fraction of the
// substep's closing along the frame-start normal that lands the pair at
// ccd_slop of penetration. The pose is integrated and cab/sab are its own;
// the substep-start anchors and normal come from q0, with the expressions
// of the velocity pass that carries them in the reference.
__device__ __forceinline__ float ccd_slots(const Shared& s,
                                           const Frame2Args& a,
                                           const SlotRow& t, int K, int ob,
                                           const Pose0& q0, float f_col) {
  const float o_px = s.px[ob], o_py = s.py[ob];
  const float o_ca = s.cab[ob], o_sa = s.sab[ob];
  const float q_px = q0.x[ob], q_py = q0.y[ob];
  const float q_ca = q0.c[ob], q_sa = q0.s[ob];
  for (int c = 0; c < K; ++c) {
    const int mk = t.mask(c);
    if (!(mk & (F2_SM0 | F2_SM1))) continue;
    const int pb = s.cbody[t.partner(c)];
    const float p_px = s.px[pb], p_py = s.py[pb];
    const float p_ca = s.cab[pb], p_sa = s.sab[pb];
    const float r_px = q0.x[pb], r_py = q0.y[pb];
    const float r_ca = q0.c[pb], r_sa = q0.s[pb];
    const float n_ax = t.at(F2_NAX, c), n_ay = t.at(F2_NAY, c);
    const float nx0 = q_ca * n_ax - q_sa * n_ay;
    const float ny0 = q_sa * n_ax + q_ca * n_ay;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (!(mk & (F2_SM0 << p))) continue;
      const float a_ax = t.at(F2_AAX0 + p, c), a_ay = t.at(F2_AAY0 + p, c);
      const float b_ax = t.at(F2_BAX0 + p, c), b_ay = t.at(F2_BAY0 + p, c);
      const float wax0 = q_px + (q_ca * a_ax - q_sa * a_ay);
      const float way0 = q_py + (q_sa * a_ax + q_ca * a_ay);
      const float wbx0 = r_px + (r_ca * b_ax - r_sa * b_ay);
      const float wby0 = r_py + (r_sa * b_ax + r_ca * b_ay);
      const float wax1 = o_px + (o_ca * a_ax - o_sa * a_ay);
      const float way1 = o_py + (o_sa * a_ax + o_ca * a_ay);
      const float wbx1 = p_px + (p_ca * b_ax - p_sa * b_ay);
      const float wby1 = p_py + (p_sa * b_ax + p_ca * b_ay);
      const float c0 = (wbx0 - wax0) * nx0 + (wby0 - way0) * ny0;
      const float c1 = (wbx1 - wax1) * nx0 + (wby1 - way1) * ny0;
      const float advance = c0 - c1;
      const float allowed = fmaxf(c0, 0.f) + a.ccd_slop;
      if (advance > allowed)
        f_col = fminf(f_col, allowed / fmaxf(advance, 1e-10f));
    }
  }
  return f_col;
}

// Per-frame solve-slot compaction of row i (frame2.py:361-426), by the
// thread that owns the row: each of its C slots' tier (0 touching, 1
// imminent sep < margin, 2 speculative-active, 3 empty) and smallest active
// separation, the rank of every slot in the exact total order (tier, sep,
// slot index) into `perm` (perm[r]: the slot of rank r), and the row's
// counts in o_nact. `slot(c, u)` sets slot c up (false: an empty slot).
template <class SlotFn>
__device__ __forceinline__ void rank_row(const Frame2Args& a, int i,
                                         SlotFn slot, int (&tier)[kMaxC],
                                         int (&perm)[kMaxC]) {
  const long long w = blockIdx.x;
  const int C = a.C, M = a.M;
  float key[kMaxC];
  float n_imm = 0.f, n_act = 0.f;
  for (int c = 0; c < C; ++c) {
    SlotSetup u;
    const bool live = slot(c, u);
    const bool pm_any = live && (u.mask & (F2_PM0 | F2_PM1));
    key[c] = pm_any ? u.sep_min : 1e9f;
    tier[c] = live && (u.mask & F2_TOUCHED)   ? 0
              : (key[c] < a.margin && pm_any) ? 1
              : pm_any                         ? 2
                                               : 3;
    n_imm += tier[c] <= 1 ? 1.f : 0.f;
    n_act += tier[c] <= 2 ? 1.f : 0.f;
  }
  for (int c = 0; c < C; ++c) {
    int r = 0;
    for (int c2 = 0; c2 < C; ++c2) {
      const bool before =
          tier[c2] < tier[c] ||
          (tier[c2] == tier[c] &&
           (key[c2] < key[c] || (key[c2] == key[c] && c2 < c)));
      r += (c2 != c && before) ? 1 : 0;
    }
    perm[r] = c;
  }
  a.o_nact[(w * 2) * M + i] = n_imm;
  a.o_nact[(w * 2 + 1) * M + i] = n_act;
}

// jat: `place`'s jat, which the launch passes so that no register holds it
// through the set-up (computed here, it took <8, true, *> from 4 to 44 B
// of spill stores)
template <int V, bool kJ, bool kCcd>
__global__ void __launch_bounds__(kThreads, 1)
    frame2_kernel(Frame2Args a, unsigned jat) {
  extern __shared__ float smem[];
  const int N = a.N, M = a.M, C = a.C;
  const long long w = blockIdx.x;
  const int J = kJ ? a.J : 0;
  const Shared s = carve<kJ>(smem, N, M, V, J);
  const size_t plane = (size_t)C * M;  // one [C, M] slot table of one world
  const float gx = a.gravity[2 * w], gy = a.gravity[2 * w + 1];
  const float h = a.h;
  // with compaction the substeps solve the first Cs slots of the ranked
  // table, whose partners go to o_partner
  const bool compact = a.Cs > 0;
  const int Csol = compact ? a.Cs : C;
  const long long ow = a.owner_per_world ? w : 0;

  // where the pose planes, the live set, the slot records and the joint
  // list live (see `place`)
  Placement pl = place(N, M, V, J, Csol);
  if constexpr (kJ) pl.jat = jat;
  const int R = pl.R;
  const size_t state = shared_bytes(N, M, V, J);
  const size_t pose_bytes = (size_t)4 * N * sizeof(float);
  uint8_t* const head = reinterpret_cast<uint8_t*>(smem) + state;
  // (`all_shared`, spelled out: called, it changed the contact-only
  // instances' SASS)
  uint8_t* const gs =
      pl.pose_shared && pl.live_shared && (!kJ || pl.jat > 0)
          ? nullptr
          : a.gscratch + (size_t)w * scratch_bytes(N, M, Csol, J);
  float* const pose = reinterpret_cast<float*>(
      pl.pose_shared ? head : gs + joint_bytes(J));
  const Pose0 q0 = {pose, pose + N, pose + 2 * N, pose + 3 * N};
  uint8_t* const live = pl.live_shared
                            ? reinterpret_cast<uint8_t*>(s.row + M)
                            : gs + joint_bytes(J) + pose_bytes;
  uint8_t* const stab = head + pose_bytes;
  uint8_t* const gtab =
      R < M ? a.gtab + (size_t)w * table_bytes(Csol, M - R) : nullptr;
  auto row_of = [&](int i) {
    return i < R ? table_row(stab, Csol, R, i)
                 : table_row(gtab, Csol, M - R, i - R);
  };

  // ---- load the world ----------------------------------------------------
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const long long g = w * N + n;
    s.px[n] = a.posx[g]; s.py[n] = a.posy[g]; s.an[n] = a.ang[g];
    s.vx[n] = a.velx[g]; s.vy[n] = a.vely[g]; s.om[n] = a.angvel[g];
    s.invm[n] = a.invm[g]; s.invi[n] = a.invi[g];
    s.dyn[n] = a.dyn[g]; s.kin[n] = a.kin[g];
    s.cab[n] = cosf(s.an[n]); s.sab[n] = sinf(s.an[n]);
    s.spd[n] = sqrtf(s.vx[n] * s.vx[n] + s.vy[n] * s.vy[n]);
    q0.x[n] = s.px[n]; q0.y[n] = s.py[n];
    q0.c[n] = s.cab[n]; q0.s[n] = s.sab[n];
  }
  for (int n = threadIdx.x; n <= N; n += blockDim.x)
    s.ostart[n] = a.owner_start[ow * (N + 1) + n];
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const long long g = w * M + i;
    s.cbody[i] = a.cbody[g]; s.nv[i] = a.nverts[g]; s.rad[i] = a.radius[g];
    s.fric[i] = a.fric[g]; s.rest[i] = a.rest[g]; s.sens[i] = a.sensor[g];
    s.oidx[i] = a.owner_idx[ow * M + i];
    float ext = 0.f;
    for (int v = 0; v < V; ++v) {
      const float x = a.vlx[(w * V + v) * M + i];
      const float y = a.vly[(w * V + v) * M + i];
      s.vlx[v * M + i] = x;
      s.vly[v * M + i] = y;
      const float d = sqrtf(x * x + y * y);
      ext = v ? fmaxf(ext, d) : d;
    }
    s.ext[i] = ext + s.rad[i];  // conservative rotation speed arm
  }
  if constexpr (kJ) {
    for (int k = threadIdx.x; k < a.J; k += blockDim.x) {
      const long long g = w * a.J + k;
      s.jty[k] = a.jtype[g]; s.jba[k] = a.jba[g]; s.jbb[k] = a.jbb[g];
      s.jcol[k] = a.jcolor[g];
      s.jaax[k] = a.jaax[g]; s.jaay[k] = a.jaay[g];
      s.jabx[k] = a.jabx[g]; s.jaby[k] = a.jaby[g];
      s.jrest[k] = a.jrest[g]; s.jlo[k] = a.jlo[g]; s.jhi[k] = a.jhi[g];
      s.jcomp[k] = a.jcomp[g]; s.jdamp[k] = a.jdamp[g];
      s.jms[k] = a.jms[g]; s.jmm[k] = a.jmm[g];
    }
  }
  __syncthreads();

  // ---- frame setup: manifolds and slot records ---------------------------
  // slot c of row i at the frame-start pose (false: an empty slot)
  auto slot = [&](int i, int c, SlotSetup& u) {
    const size_t g = (size_t)w * plane + (size_t)c * M + i;
    const float act = a.slot_act[g];
    if (act == 0.f) return false;  // empty: every mask zero
    const int ob = s.cbody[i];
    const float o_px = s.px[ob], o_py = s.py[ob];
    const float o_ca = s.cab[ob], o_sa = s.sab[ob];
    const float o_spd = s.spd[ob] + fabsf(s.om[ob]) * s.ext[i];
    float vax[V], vay[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float x = s.vlx[v * M + i], y = s.vly[v * M + i];
      vax[v] = o_px + o_ca * x - o_sa * y;
      vay[v] = o_py + o_sa * x + o_ca * y;
    }
    setup_slot<V>(s, a, i, a.partner[g], act, vax, vay, o_px, o_py, o_ca,
                  o_sa, o_spd, u);
    return true;
  };
  if (!compact) {  // slot-parallel: one (row, slot) item at a time
    for_items(C, M, [&](int i, int c) {
      const SlotRow t = row_of(i);
      SlotSetup su;
      if (slot(i, c, su))
        store_slot(t, c, su);
      else
        t.mask(c) = 0;
    });
  }
  // compaction: a thread ranks a row's C slots, then sets the winners up
  // again straight into their ranks of the table (the same values: the
  // same expressions on the same inputs); the dropped ones' records (kCcd:
  // the TOI still takes them) go to the side table, their `touched` and
  // every rank's partner to the outputs
  for (int i = threadIdx.x; compact && i < M; i += blockDim.x) {
    const SlotRow t = row_of(i);
    int tier[kMaxC], perm[kMaxC];
    rank_row(a, i, [&](int c, SlotSetup& u) { return slot(i, c, u); }, tier,
             perm);
    for (int r = 0; r < C; ++r) {
      const int c = perm[r];
      const size_t go = (size_t)w * plane + (size_t)r * M + i;
      a.o_partner[go] = a.partner[(size_t)w * plane + (size_t)c * M + i];
      SlotSetup u;
      if (r < Csol) {
        if (slot(i, c, u))
          store_slot(t, r, u);
        else
          t.mask(r) = 0;
        continue;
      }
      a.o_touched[go] = tier[c] == 0 ? 1.f : 0.f;
      if constexpr (kCcd) {
        const SlotRow d =
            table_row(a.side + (size_t)w * table_bytes(C - Csol, M),
                      C - Csol, M, i);
        if (slot(i, c, u))
          store_slot(d, r - Csol, u);
        else
          d.mask(r - Csol) = 0;
      }
    }
  }
  __syncthreads();

  // ---- the live set (see the header note) ---------------------------------
  // Row bits by a thread a row; the list by rounds of blockDim.x items, each
  // warp's ballot placed after the live items of the rounds before and of
  // the lower warps (their counts double-buffered, so a round takes one
  // barrier). Every thread ends with the set's size.
  int* const wcnt = reinterpret_cast<int*>(live);
  LiveSet L = {reinterpret_cast<uint32_t*>(live) + kLiveCounts,
               reinterpret_cast<uint32_t*>(live) + kLiveCounts +
                   live_words(Csol) * M,
               0, live_wide(M, Csol),
               (unsigned)((0x100000000ull + M - 1) / M)};
  constexpr int kPM = F2_PM0 | F2_PM1;
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const SlotRow t = row_of(i);
    for (int c0 = 0; c0 < Csol; c0 += 32) {
      uint32_t b = 0;
      for (int c = c0; c < Csol && c < c0 + 32; ++c)
        b |= (t.mask(c) & kPM) ? 1u << (c - c0) : 0u;
      L.bits[(c0 / 32) * M + i] = b;
    }
  }
  {
    const int items = Csol * M, lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    const int di = blockDim.x % M, dc = blockDim.x / M;
    int i = threadIdx.x % M, c = threadIdx.x / M;  // item u = base + tid
    for (int base = 0, buf = 0; base < items;
         base += blockDim.x, buf ^= 32) {
      const int u = base + threadIdx.x;
      const bool on = u < items && (row_of(i).mask(c) & kPM);
      const unsigned b = __ballot_sync(0xffffffffu, on);
      if (lane == 0) wcnt[buf + warp] = __popc(b);
      __syncthreads();
      int at = L.n, total = 0;
      for (int k = 0; k < warps; ++k) {
        const int n = wcnt[buf + k];
        at += k < warp ? n : 0;
        total += n;
      }
      if (on) {
        at += __popc(b & ((1u << lane) - 1u));
        if (L.wide)
          static_cast<uint32_t*>(L.list)[at] = (uint32_t)u;
        else
          static_cast<uint16_t*>(L.list)[at] = (uint16_t)u;
      }
      L.n += total;
      i += di;
      c += dc;
      if (i >= M) {
        i -= M;
        ++c;
      }
    }
  }
  if (threadIdx.x == 0 && a.live_items != nullptr)
    atomicAdd(a.live_items, (unsigned long long)L.n);

  // ---- the joint list (kJ; see the header note) ---------------------------
  // A thread a body, by rounds of blockDim.x bodies: its live slots' count,
  // placed after the items of the rounds before and of the lower threads
  // (a warp's inclusive scan by shuffles, the warps' totals double-buffered
  // as the live set's counts), then its records. Starts are held to the K
  // records (the slot tables of joint_slots.cu never reach it); the last,
  // s.jstart[N], is the list's size. The list heads the world's scratch
  // where pl.jat is 0.
  int* const jcnt = reinterpret_cast<int*>(
      pl.jat > 0 ? reinterpret_cast<uint8_t*>(smem) + pl.jat : gs);
  const JointList jl = {jcnt + kLiveCounts, 2 * J};
  if constexpr (kJ) {
    int jitems = 0;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    for (int base = 0, buf = 0; base < N; base += blockDim.x, buf ^= 32) {
      const int n = base + threadIdx.x;
      int cnt = 0;
      for (int jc = 0; n < N && jc < a.JC; ++jc)
        cnt += a.jact[(w * a.JC + jc) * N + n] != 0.f ? 1 : 0;
      int incl = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += x;
      }
      if (lane == 31) jcnt[buf + warp] = incl;
      __syncthreads();
      int at = jitems, total = 0;
      for (int k = 0; k < warps; ++k) {
        const int x = jcnt[buf + k];
        at += k < warp ? x : 0;
        total += x;
      }
      at += incl - cnt;
      if (n < N) {
        s.jstart[n] = min(at, jl.K);
        for (int jc = 0; jc < a.JC; ++jc) {
          if (a.jact[(w * a.JC + jc) * N + n] == 0.f) continue;
          if (at < jl.K) jl.store(at, n, joint_slot(s, a, w, jc, n));
          ++at;
        }
      }
      jitems += total;
    }
    if (threadIdx.x == 0) {
      s.jstart[N] = min(jitems, jl.K);
      if (a.live_joint_items != nullptr)
        atomicAdd(a.live_joint_items, (unsigned long long)jitems);
    }
  }

  // ---- substeps ------------------------------------------------------------
  // Every phase that moves a body's angle also refreshes its cab/sab, so a
  // phase that reads them finds cos/sin of the current angle, which is what
  // the reference recomputes before each pass; a body phase that follows
  // another body phase with no slot phase between them runs in the same
  // loop (they touch only body n).
  // integrate (semi-implicit Euler) body n into the substep
  auto integrate = [&](int n) {
    const float dyn = s.dyn[n];
    const float vx = s.vx[n] + gx * h * dyn;
    const float vy = s.vy[n] + gy * h * dyn;
    if constexpr (kCcd) {  // the substep-start pose, for the TOI clamp
      s.dxx[n] = s.px[n]; s.dxy[n] = s.py[n]; s.dth[n] = s.an[n];
    }
    s.vx[n] = vx; s.vy[n] = vy;
    s.px[n] = s.px[n] + vx * h;
    s.py[n] = s.py[n] + vy * h;
    s.an[n] = s.an[n] + s.om[n] * h;
    s.vtx[n] = vx; s.vty[n] = vy; s.vtom[n] = s.om[n];
    s.cab[n] = cosf(s.an[n]);
    s.sab[n] = sinf(s.an[n]);
    if constexpr (!kCcd) {
      s.dxx[n] = 0.f; s.dxy[n] = 0.f; s.dth[n] = 0.f;
    }
  };
  // velocity reconstruction (kinematic bodies keep their velocity); the
  // pose is final for the substep, so it is also the next one's start
  auto reconstruct = [&](int n) {
    const float kin = s.kin[n], nk = 1.f - kin;
    s.vx[n] = kin * s.vx[n] + nk * (s.vtx[n] + s.dxx[n] / h);
    s.vy[n] = kin * s.vy[n] + nk * (s.vty[n] + s.dxy[n] / h);
    s.om[n] = kin * s.om[n] + nk * (s.vtom[n] + s.dth[n] / h);
    q0.x[n] = s.px[n]; q0.y[n] = s.py[n];
    q0.c[n] = s.cab[n]; q0.s[n] = s.sab[n];
  };
  // the body sums of a pass: body n's colliders' rows (ascending), each the
  // terms its live slots left in their records, in slot order (the slots
  // without an active point left none)
  auto body_sums = [&](int n, float (&out)[4]) {
    out[0] = out[1] = out[2] = out[3] = 0.f;
    for (int k = s.ostart[n]; k < s.ostart[n + 1]; ++k) {
      const int i = s.oidx[k];
      const SlotRow t = row_of(i);
      float r[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c0 = 0; c0 < Csol; c0 += 32) {
        for (uint32_t b = L.bits[(c0 / 32) * M + i]; b; b &= b - 1) {
          const int c = c0 + __ffs(b) - 1;
#pragma unroll
          for (int q = 0; q < 4; ++q) r[q] += t.at(F2_T0 + q, c);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) out[q] += r[q];
    }
  };
  // with coloured joints the reconstruction follows the last pass
  const bool colored = kJ && a.joint_colored;
  for (int n = threadIdx.x; n < N; n += blockDim.x) integrate(n);
  for (int step = 0; step < a.substeps; ++step) {
    __syncthreads();
    if constexpr (kCcd) {
      // TOI clamp: each row's factor over every slot of its table (the
      // solved ones, then those compaction dropped), then each body's over
      // its colliders
      for (int i = threadIdx.x; i < M; i += blockDim.x) {
        const int ob = s.cbody[i];
        float f = 1.f;
        if (a.bullet[w * N + ob] > 0.f) {
          f = ccd_slots(s, a, row_of(i), Csol, ob, q0, f);
          if (compact)
            f = ccd_slots(
                s, a,
                table_row(a.side + (size_t)w * table_bytes(C - Csol, M),
                          C - Csol, M, i),
                C - Csol, ob, q0, f);
        }
        s.row[i] = 1.f - f;
      }
      __syncthreads();
      for (int n = threadIdx.x; n < N; n += blockDim.x) {
        float neg = 0.f;
        for (int k = s.ostart[n]; k < s.ostart[n + 1]; ++k)
          neg += s.row[s.oidx[k]];
        const float fb = fminf(fmaxf(1.f - neg, 0.f), 1.f);
        if (fb < 1.f) {  // unclamped bodies keep their pose bitwise
          s.px[n] = s.dxx[n] + fb * (s.px[n] - s.dxx[n]);
          s.py[n] = s.dxy[n] + fb * (s.py[n] - s.dxy[n]);
          s.an[n] = s.dth[n] + fb * (s.an[n] - s.dth[n]);
          s.cab[n] = cosf(s.an[n]);
          s.sab[n] = sinf(s.an[n]);
        }
        s.dxx[n] = 0.f; s.dxy[n] = 0.f; s.dth[n] = 0.f;
      }
      __syncthreads();
    }
    for (int it = 0; it < a.iterations; ++it) {
      const bool last = it == a.iterations - 1;
      // Jacobi contact projection over the live items: every slot reads
      // the iteration-start pose and leaves its row-sum terms in its record
      for_live(L, M, [&](int i, int c) {
        const SlotRow t = row_of(i);
        const int mk = t.mask(c);
        const int ob = s.cbody[i];
        const float ima = s.invm[ob], iia = s.invi[ob];
        const float o_px = s.px[ob], o_py = s.py[ob];
        const float o_ca = s.cab[ob], o_sa = s.sab[ob];
        const float q_px = q0.x[ob], q_py = q0.y[ob];
        const float q_ca = q0.c[ob], q_sa = q0.s[ob];
        const int pc = t.partner(c);
        const int pb = s.cbody[pc];
        const float p_px = s.px[pb], p_py = s.py[pb];
        const float p_ca = s.cab[pb], p_sa = s.sab[pb];
        const float r_px = q0.x[pb], r_py = q0.y[pb];
        const float r_ca = q0.c[pb], r_sa = q0.s[pb];
        const float imb = s.invm[pb], iib = s.invi[pb];
        const float fric = sqrtf(s.fric[i] * s.fric[pc]);
        const float n_ax = t.at(F2_NAX, c), n_ay = t.at(F2_NAY, c);
        const float nx = o_ca * n_ax - o_sa * n_ay;
        const float ny = o_sa * n_ax + o_ca * n_ay;
        float cax = 0.f, cay = 0.f, dang = 0.f, nact = 0.f;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float a_ax = t.at(F2_AAX0 + p, c);
          const float a_ay = t.at(F2_AAY0 + p, c);
          const float b_ax = t.at(F2_BAX0 + p, c);
          const float b_ay = t.at(F2_BAY0 + p, c);
          const float rax = o_ca * a_ax - o_sa * a_ay;
          const float ray = o_sa * a_ax + o_ca * a_ay;
          const float rbx = p_ca * b_ax - p_sa * b_ay;
          const float rby = p_sa * b_ax + p_ca * b_ay;
          const float wax = o_px + rax, way = o_py + ray;
          const float wbx = p_px + rbx, wby = p_py + rby;
          // the static-friction reference: the anchors at the substep's
          // start (wax0, way0, wbx0, wby0)
          const float ref[4] = {q_px + (q_ca * a_ax - q_sa * a_ay),
                                q_py + (q_sa * a_ax + q_ca * a_ay),
                                r_px + (r_ca * b_ax - r_sa * b_ay),
                                r_py + (r_sa * b_ax + r_ca * b_ay)};
          float ax, ay, da, dlam;
          bool active;
          project_point(
              rax, ray, rbx, rby, wax, way, wbx, wby, nx, ny,
              [&] { return (mk & (F2_SM0 << p)) ? 1.f : 0.f; },
              [&](int k) { return ref[k]; }, ima, iia, imb, iib, fric,
              a.alpha_t, ax, ay, da, dlam, active);
          cax = p ? cax + ax : ax;
          cay = p ? cay + ay : ay;
          dang = p ? dang + da : da;
          nact += active ? 1.f : 0.f;
          float& lam = t.at(F2_LAM0 + p, c);
          lam = (it ? lam : 0.f) + dlam;
        }
        t.at(F2_T0, c) = cax * ima;
        t.at(F2_T1, c) = cay * ima;
        t.at(F2_T2, c) = dang;
        t.at(F2_T3, c) = nact;
      });
      if constexpr (kJ) {
        // Jacobi joints: solved at the iteration-start pose, like contacts
        if (!a.joint_colored) joint_pass<false>(s, a, jl, -1, false);
      }
      __syncthreads();
      for (int n = threadIdx.x; n < N; n += blockDim.x) {
        float ab[4];
        body_sums(n, ab);
        if constexpr (kJ) {
          if (!a.joint_colored) {
            float jt[4];
            joint_terms(s, jl, n, -1, false, jt);
#pragma unroll
            for (int q = 0; q < 4; ++q) ab[q] = ab[q] + jt[q];
          }
        }
        const float cnt = fmaxf(ab[3], 1.f);
        const float md = a.max_dpos;
        const float ddx = fminf(fmaxf(ab[0] * a.relaxation / cnt, -md), md);
        const float ddy = fminf(fmaxf(ab[1] * a.relaxation / cnt, -md), md);
        const float dda = fminf(fmaxf(ab[2] * a.relaxation / cnt, -md), md);
        s.px[n] = s.px[n] + ddx;
        s.py[n] = s.py[n] + ddy;
        s.an[n] = s.an[n] + dda;
        s.dxx[n] = s.dxx[n] + ddx;
        s.dxy[n] = s.dxy[n] + ddy;
        s.dth[n] = s.dth[n] + dda;
        s.cab[n] = cosf(s.an[n]);
        s.sab[n] = sinf(s.an[n]);
        if (last && !colored) reconstruct(n);
      }
      if constexpr (kJ) {
        // coloured Gauss-Seidel: same-colour joints share no dynamic body,
        // so each pass applies exactly; the pose refreshes between passes
        for (int color = 0; colored && color < a.n_colors; ++color) {
          const bool last_color = color == a.n_colors - 1;
          __syncthreads();
          joint_pass<false>(s, a, jl, color, last_color);
          __syncthreads();
          for (int n = threadIdx.x; n < N; n += blockDim.x) {
            float jt[4];
            // a body the pass did not reach: its sums are +0, and +0 / 1
            // is +0
            float qx = 0.f, qy = 0.f, qa = 0.f;
            if (joint_terms(s, jl, n, color, last_color, jt)) {
              const float cnt = fmaxf(jt[3], 1.f);
              qx = jt[0] / cnt;
              qy = jt[1] / cnt;
              qa = jt[2] / cnt;
            }
            // constraint upkeep, not depenetration: the raw max_dpos
            const float md = a.max_dpos_joint;
            const float jdx = fminf(fmaxf(qx, -md), md);
            const float jdy = fminf(fmaxf(qy, -md), md);
            const float jda = fminf(fmaxf(qa, -md), md);
            const float an0 = s.an[n], an1 = an0 + jda;
            s.px[n] = s.px[n] + jdx;
            s.py[n] = s.py[n] + jdy;
            s.an[n] = an1;
            s.dxx[n] = s.dxx[n] + jdx;
            s.dxy[n] = s.dxy[n] + jdy;
            s.dth[n] = s.dth[n] + jda;
            // cab/sab hold cos/sin of an0 (every phase that moves an angle
            // refreshes them): an angle that keeps its bits keeps them
            if (__float_as_uint(an1) != __float_as_uint(an0)) {
              s.cab[n] = cosf(an1);
              s.sab[n] = sinf(an1);
            }
            if (last && last_color) reconstruct(n);
          }
        }
      }
      __syncthreads();
    }
    if (a.iterations == 0) {
      for (int n = threadIdx.x; n < N; n += blockDim.x) reconstruct(n);
      __syncthreads();
    } else if (colored && a.n_colors <= 0) {
      for (int n = threadIdx.x; n < N; n += blockDim.x) reconstruct(n);
      __syncthreads();
    }
    // velocity pass over the live items: restitution + dynamic friction
    for_live(L, M, [&](int i, int c) {
      const SlotRow t = row_of(i);
      const int mk = t.mask(c);
      const int ob = s.cbody[i];
      const float ima = s.invm[ob], iia = s.invi[ob];
      const float o_ca = s.cab[ob], o_sa = s.sab[ob];
      const float vax = s.vx[ob], vay = s.vy[ob], oa = s.om[ob];
      const float v0ax = s.vtx[ob], v0ay = s.vty[ob], o0a = s.vtom[ob];
      const int pc = t.partner(c);
      const int pb = s.cbody[pc];
      const float p_ca = s.cab[pb], p_sa = s.sab[pb];
      const float vbx = s.vx[pb], vby = s.vy[pb], ob_ = s.om[pb];
      const float v0bx = s.vtx[pb], v0by = s.vty[pb], o0b = s.vtom[pb];
      const float imb = s.invm[pb], iib = s.invi[pb];
      const float fric = sqrtf(s.fric[i] * s.fric[pc]);
      const float rest = fmaxf(s.rest[i], s.rest[pc]);
      const float n_ax = t.at(F2_NAX, c), n_ay = t.at(F2_NAY, c);
      const float nx = o_ca * n_ax - o_sa * n_ay;
      const float ny = o_sa * n_ax + o_ca * n_ay;
      float cbx = 0.f, cby = 0.f, dng = 0.f, nact = 0.f;
      bool tk = false;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float a_ax = t.at(F2_AAX0 + p, c);
        const float a_ay = t.at(F2_AAY0 + p, c);
        const float b_ax = t.at(F2_BAX0 + p, c);
        const float b_ay = t.at(F2_BAY0 + p, c);
        const float rax = o_ca * a_ax - o_sa * a_ay;
        const float ray = o_sa * a_ax + o_ca * a_ay;
        const float rbx = p_ca * b_ax - p_sa * b_ay;
        const float rby = p_sa * b_ax + p_ca * b_ay;
        const float lam = t.at(F2_LAM0 + p, c);
        float impx, impy, dd;
        bool active;
        velocity_point(
            rax, ray, rbx, rby, nx, ny, vax, vay, oa, vbx, vby, ob_, v0ax,
            v0ay, o0a, v0bx, v0by, o0b, [&] { return lam; },
            [&] { return (mk & (F2_SM0 << p)) ? 1.f : 0.f; }, ima, iia, imb,
            iib, rest, fric, h, a.rest_threshold, impx, impy, dd, active);
        cbx = p ? cbx + impx : impx;
        cby = p ? cby + impy : impy;
        dng = p ? dng + dd : dd;
        nact += active ? 1.f : 0.f;
        tk = tk || (lam > 0.f && (mk & (F2_PM0 << p)));
      }
      t.at(F2_T0, c) = -cbx * ima;
      t.at(F2_T1, c) = -cby * ima;
      t.at(F2_T2, c) = -dng;
      t.at(F2_T3, c) = nact;
      if (tk) t.mask(c) = (uint8_t)(mk | F2_TOUCHED);
    });
    if constexpr (kJ) {
      // motors and joint damping, at the post-solve pose and velocities
      joint_pass<true>(s, a, jl, -1, false);
    }
    __syncthreads();
    // the velocity pass's apply, then the next substep's integrate
    const bool more = step + 1 < a.substeps;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      float ab[4];
      body_sums(n, ab);
      if constexpr (kJ) {
        float jt[4];
        joint_terms(s, jl, n, -1, false, jt);
#pragma unroll
        for (int q = 0; q < 4; ++q) ab[q] = ab[q] + jt[q];
      }
      const float cnt = fmaxf(ab[3], 1.f);
      float vx = s.vx[n] + ab[0] / cnt;
      float vy = s.vy[n] + ab[1] / cnt;
      float om = s.om[n] + ab[2] / cnt;
      if (a.use_lin_damp) {
        vx = vx * a.lin_sdamp;
        vy = vy * a.lin_sdamp;
      }
      if (a.use_ang_damp) om = om * a.ang_sdamp;
      s.vx[n] = vx; s.vy[n] = vy; s.om[n] = om;
      if (more) integrate(n);
    }
  }
  __syncthreads();

  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const long long g = w * N + n;
    a.o_posx[g] = s.px[n]; a.o_posy[g] = s.py[n]; a.o_ang[g] = s.an[n];
    a.o_velx[g] = s.vx[n]; a.o_vely[g] = s.vy[n]; a.o_angvel[g] = s.om[n];
  }
  // `touched` of the solved slots, once (the velocity passes kept its
  // running max in each record's mask byte; each thread reads its own rows)
  for_items(Csol, M, [&](int i, int c) {
    a.o_touched[(size_t)w * plane + (size_t)c * M + i] =
        (row_of(i).mask(c) & F2_TOUCHED) ? 1.f : 0.f;
  });
}

template <int V, bool kJ, bool kCcd>
int launch(const Frame2Args& a, cudaStream_t stream) {
  const int Csol = a.Cs > 0 ? a.Cs : a.C;
  const Placement pl = place(a.N, a.M, V, kJ ? a.J : 0, Csol);
  // a shape the wrapper cannot place, or a global table it did not give
  if (pl.R < 0 || (pl.R < a.M && a.gtab == nullptr) ||
      (!all_shared(pl, kJ ? a.J : 0) && a.gscratch == nullptr) ||
      (kCcd && a.Cs > 0 && a.side == nullptr) ||
      (unsigned long long)Csol * a.M * a.M > (1ull << 32))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      frame2_kernel<V, kJ, kCcd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pl.bytes);
  if (err != cudaSuccess) return (int)err;
  if (a.W > 0)
    frame2_kernel<V, kJ, kCcd>
        <<<a.W, block_threads(pl.bytes), pl.bytes, stream>>>(a, pl.jat);
  return (int)cudaGetLastError();
}

template <int V, bool kJ>
int launch_ccd(const Frame2Args& a, cudaStream_t stream) {
  return a.ccd ? launch<V, kJ, true>(a, stream) : launch<V, kJ, false>(a, stream);
}

// Resident blocks an SM of the instance <V, kJ, kCcd> at these shapes.
template <int V, bool kJ, bool kCcd>
int blocks_per_sm(int N, int M, int J, int Csol) {
  const Placement pl = place(N, M, V, kJ ? J : 0, Csol);
  if (pl.R < 0) return -1;
  if (cudaFuncSetAttribute(frame2_kernel<V, kJ, kCcd>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)pl.bytes) != cudaSuccess)
    return -1;
  int n = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, frame2_kernel<V, kJ, kCcd>, block_threads(pl.bytes),
          pl.bytes) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

SF_EXPORT(sf_frame2, Frame2Args)

extern "C" int sf_frame2_fields() { return F2_FIELDS; }

extern "C" int sf_frame2_slot_bytes() { return F2_SLOT_BYTES; }

extern "C" long long sf_frame2_shared_bytes(int N, int M, int V, int J,
                                            int Csol) {
  return (long long)place(N, M, V, J, Csol).bytes;
}

extern "C" int sf_frame2_table_rows(int N, int M, int V, int J, int Csol) {
  return place(N, M, V, J, Csol).R;
}

// Bytes of a world's global scratch the launch needs (0: none).
extern "C" long long sf_frame2_scratch_bytes(int N, int M, int V, int J,
                                             int Csol) {
  const Placement pl = place(N, M, V, J, Csol);
  return all_shared(pl, J) ? 0 : (long long)scratch_bytes(N, M, Csol, J);
}

// Whether the joint list of a launch at these shapes sits in shared memory.
extern "C" int sf_frame2_joints_shared(int N, int M, int V, int J,
                                       int Csol) {
  return J > 0 && place(N, M, V, J, Csol).jat > 0 ? 1 : 0;
}

extern "C" int sf_frame2_block_threads(int N, int M, int V, int J,
                                       int Csol) {
  return block_threads(place(N, M, V, J, Csol).bytes);
}

extern "C" int sf_frame2_blocks_per_sm(int V, int J, int ccd, int N, int M,
                                       int Csol) {
  const bool kJ = J > 0;
  if (V == 4)
    return kJ ? (ccd ? blocks_per_sm<4, true, true>(N, M, J, Csol)
                     : blocks_per_sm<4, true, false>(N, M, J, Csol))
              : (ccd ? blocks_per_sm<4, false, true>(N, M, J, Csol)
                     : blocks_per_sm<4, false, false>(N, M, J, Csol));
  if (V == 8)
    return kJ ? (ccd ? blocks_per_sm<8, true, true>(N, M, J, Csol)
                     : blocks_per_sm<8, true, false>(N, M, J, Csol))
              : (ccd ? blocks_per_sm<8, false, true>(N, M, J, Csol)
                     : blocks_per_sm<8, false, false>(N, M, J, Csol));
  return -1;
}

extern "C" int sf_frame2(const Frame2Args* a, void* stream) {
  // the wrapper pads vertex rows (repeating v0, which leaves every min, max
  // and manifold unchanged) to one of the compiled widths
  const cudaStream_t st = (cudaStream_t)stream;
  const bool joints = a->J > 0;
  switch (a->V) {
    case 4:
      return joints ? launch_ccd<4, true>(*a, st) : launch_ccd<4, false>(*a, st);
    case 8:
      return joints ? launch_ccd<8, true>(*a, st) : launch_ccd<8, false>(*a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
