// One batched XPBD frame: frame-start contact manifolds for every slot,
// then `substeps` x [integrate -> `iterations` x Jacobi contact projection
// -> velocity reconstruction -> restitution/friction velocity pass].
//
// Replaces starframe_tpu/pallas/frame2.py `_frame2_kernel` (launched by
// `run_frame2`) for its uniform-topology, uncompacted (Cs = 0)
// configuration, contact-only or with joints (both joint tiers), with or
// without CCD. Solve-slot compaction, per-world owner tables and sleep are
// ROADMAP.md work and are refused by the wrapper.
//
// What bounds it on an H100: the per-slot frame constants. Each slot of
// each row carries ~28 floats through the frame (normal, anchors, masks,
// pair material, the carried static-friction reference, lambda): 229 KB a
// world at C = 8, M = 256, more than a block's shared memory. They live in
// a global scratch [W, F2_FIELDS, C, M] laid out so that consecutive
// threads (rows) touch consecutive addresses; every substep re-reads them
// (~0.9 GB at W = 4096). The manifold math itself is scalar SAT/clip code,
// ~1-2k flops per active slot.
//
// Design: one CTA per world, 256 threads. A thread is body n in the body
// phases and collider row i in the slot phases (strided when N or M
// exceed the block). Body state, the world's collider geometry and the
// per-row correction sums live in shared memory. The Jacobi semantics are
// the TPU's: every row reads the iteration's start pose, writes its row
// sum to shared memory, __syncthreads(), and only then do bodies apply the
// count-normalised, clipped corrections. A row sums its C slots in order
// c = 0..C-1 (frame2.py `_sum_w`), and a body sums its colliders' rows in
// ascending collider order from a CSR built off world 0's topology (what
// the TPU's one-hot dot computes). No float atomics: the frame is bitwise
// reproducible. Slots whose manifold has no active point are skipped in
// the substep loop; they contribute exact zeros in the reference. The
// static-friction reference is carried from the previous substep's
// velocity-pass kinematics, starting from the frame-start pose (kin00).
// The manifold and the per-point contact solves are the shared
// transcriptions of kernels.py in contact.cuh, over the V (templated)
// vertices.
//
// Joints (the kJ instantiation; the contact-only one compiles without any
// of it, so the main path keeps its registers and occupancy): the world's
// joint parameters (15 fields x J) live in shared memory, and a thread in
// a body phase owns that body's JC joint slots (joint_slots.cu), read
// canonicalised so the own body is endpoint A (frame2.py `jd_all`). The
// Jacobi tier sums a body's slots in order jc = 0..JC-1 during the contact
// row phase (every body reads the iteration-start pose) and adds the sum
// after the contact sum, as the reference does. The coloured Gauss-Seidel
// tier runs one pass per colour after the contact apply: each pass reads
// the pass-start pose, writes its per-body sums to shared memory,
// __syncthreads(), applies, so same-colour joints (which share no dynamic
// body) apply exactly; the last pass takes every colour >= its own. Motors
// and joint damping join the velocity pass the same way as the Jacobi sum.
//
// CCD (the kCcd instantiation, frame2.py:464-514, 621-631): after the
// integrate phase a row phase takes each bullet-owned row's TOI factor,
// the min over its slots' solved points of the fraction of the substep's
// closing along the frame-start normal that lands the pair at ccd_slop of
// penetration (anchors at the substep-start pose, carried like the
// static-friction reference, and at the integrated one); then a body phase
// sums (1 - f) over the body's colliders (the same owner lists as the row
// sums) and pulls the integrated pose back to p0 + f (p - p0) where f < 1.
// The substep-start pose waits in dxx/dxy/dth (zeroed after the clamp) and
// the carried world normal in `ccd_scratch`, so the shared-memory layout is
// the non-CCD one.

#include "common.cuh"
#include "contact.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kPi = 3.14159265358979323846f;  // pi and 2 pi rounded to f32
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr int kJointFields = 15;  // Frame2Args jtype .. jcolor
enum JointType { kDistance = 1, kPin = 2, kAngleRange = 3, kMotor = 4,
                 kWeld = 5 };  // state.py JOINT_*

struct Shared {
  // body state [N]
  float *px, *py, *an, *vx, *vy, *om, *invm, *invi, *dyn, *kin;
  float *vtx, *vty, *vtom, *cab, *sab, *dxx, *dxy, *dth, *spd;
  // collider geometry [M] (verts [V, M]) and per-row correction sums [4, M]
  float *vlx, *vly, *rad, *fric, *rest, *sens, *ext, *row;
  int *cbody, *nv, *ostart, *oidx;
  // joints (kJ only): parameters [J] and per-body joint sums [4, N]
  int *jty, *jba, *jbb, *jcol;
  float *jaax, *jaay, *jabx, *jaby, *jrest, *jlo, *jhi, *jcomp, *jdamp;
  float *jms, *jmm, *jrow;
};

__host__ __device__ inline size_t shared_bytes(int N, int M, int V, int J) {
  // body: 19 [N] planes; colliders: verts 2 [V, M], five [M] fields and the
  // [4, M] row sums; ints: cbody, nverts, owner_idx [M] and owner_start;
  // with joints: 15 [J] parameter rows and the [4, N] joint sums
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
  s.vlx = p; p += V * M;
  s.vly = p; p += V * M;
  float** colf[] = {&s.rad, &s.fric, &s.rest, &s.sens, &s.ext};
  for (float** f : colf) {
    *f = p;
    p += M;
  }
  s.row = p; p += 4 * M;
  int* q = reinterpret_cast<int*>(p);
  s.cbody = q; q += M;
  s.nv = q; q += M;
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
    s.jrow = r;
  }
  return s;
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

// Sum of body n's joint slots in order jc = 0..JC-1 into s.jrow (frame2.py
// `sum_j`): position rows (kVel false) or velocity rows. color < 0 takes
// every joint; else only that colour, or >= it on the last pass. A slot
// that is empty or filtered out adds exact zeros in the reference, so it
// is skipped here.
template <bool kVel>
__device__ __forceinline__ void joint_sums(const Shared& s,
                                           const Frame2Args& a, long long w,
                                           int n, int color, bool last) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int jc = 0; jc < a.JC; ++jc) {
    const JointSlot j = joint_slot(s, a, w, jc, n);
    float active = j.act;
    if (color >= 0 && !(last ? j.color >= color : j.color == color))
      active = 0.f;
    if (active == 0.f) continue;
    float v[4];
    if constexpr (kVel)
      velocity_joint(s, n, j, a.h, v);
    else
      solve_joint(s, n, j, active, a.hh, v);
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += v[q];
  }
  const int N = a.N;
#pragma unroll
  for (int q = 0; q < 4; ++q) s.jrow[q * N + n] = acc[q];
}

// sum of a [4, M] row-sum plane over body n's colliders, ascending
__device__ __forceinline__ void to_body(const Shared& s, int M, int n,
                                        float (&out)[4]) {
  out[0] = out[1] = out[2] = out[3] = 0.f;
  for (int k = s.ostart[n]; k < s.ostart[n + 1]; ++k) {
    const int col = s.oidx[k];
#pragma unroll
    for (int q = 0; q < 4; ++q) out[q] += s.row[q * M + col];
  }
}

// K4's TOI factor of row i (kCcd): 1 unless its body is a bullet and a
// solved point of one of its slots would close past ccd_slop this substep
// (frame2.py:482-504). The pose is integrated and cab/sab are its own.
__device__ __forceinline__ float ccd_row_factor(const Shared& s,
                                                const Frame2Args& a,
                                                const float* scr,
                                                const float* cscr,
                                                long long w, int i,
                                                size_t plane) {
  const int ob = s.cbody[i];
  if (!(a.bullet[w * a.N + ob] > 0.f)) return 1.f;
  const float o_px = s.px[ob], o_py = s.py[ob];
  const float o_ca = s.cab[ob], o_sa = s.sab[ob];
  float f_col = 1.f;
  for (int c = 0; c < a.C; ++c) {
    const size_t t = (size_t)c * a.M + i;
    const float* f = scr + t;
    const float sm[2] = {f[F2_SM0 * plane], f[F2_SM1 * plane]};
    if (!(sm[0] > 0.f) && !(sm[1] > 0.f)) continue;
    const int pb = s.cbody[a.partner[(size_t)w * plane + t]];
    const float p_px = s.px[pb], p_py = s.py[pb];
    const float p_ca = s.cab[pb], p_sa = s.sab[pb];
    const float nx0 = cscr[t], ny0 = cscr[plane + t];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (!(sm[p] > 0.f)) continue;
      const float a_ax = f[(F2_AAX0 + p) * plane];
      const float a_ay = f[(F2_AAY0 + p) * plane];
      const float b_ax = f[(F2_BAX0 + p) * plane];
      const float b_ay = f[(F2_BAY0 + p) * plane];
      const float wax0 = f[(F2_WAX0 + p) * plane];
      const float way0 = f[(F2_WAY0 + p) * plane];
      const float wbx0 = f[(F2_WBX0 + p) * plane];
      const float wby0 = f[(F2_WBY0 + p) * plane];
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

template <int V, bool kJ, bool kCcd>
__global__ void __launch_bounds__(kThreads) frame2_kernel(Frame2Args a) {
  extern __shared__ float smem[];
  const int N = a.N, M = a.M, C = a.C;
  const long long w = blockIdx.x;
  const Shared s = carve<kJ>(smem, N, M, V, a.J);
  const size_t plane = (size_t)C * M;  // one scratch field of one world
  float* scr = a.scratch + (size_t)w * F2_FIELDS * plane;
  // kCcd: the carried world normal [2, C, M] of this world
  float* cscr = kCcd ? a.ccd_scratch + (size_t)w * 2 * plane : nullptr;
  const float gx = a.gravity[2 * w], gy = a.gravity[2 * w + 1];
  const float h = a.h;

  // ---- load the world ----------------------------------------------------
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const long long g = w * N + n;
    s.px[n] = a.posx[g]; s.py[n] = a.posy[g]; s.an[n] = a.ang[g];
    s.vx[n] = a.velx[g]; s.vy[n] = a.vely[g]; s.om[n] = a.angvel[g];
    s.invm[n] = a.invm[g]; s.invi[n] = a.invi[g];
    s.dyn[n] = a.dyn[g]; s.kin[n] = a.kin[g];
    s.cab[n] = cosf(s.an[n]); s.sab[n] = sinf(s.an[n]);
    s.spd[n] = sqrtf(s.vx[n] * s.vx[n] + s.vy[n] * s.vy[n]);
  }
  for (int n = threadIdx.x; n <= N; n += blockDim.x) s.ostart[n] = a.owner_start[n];
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const long long g = w * M + i;
    s.cbody[i] = a.cbody[g]; s.nv[i] = a.nverts[g]; s.rad[i] = a.radius[g];
    s.fric[i] = a.fric[g]; s.rest[i] = a.rest[g]; s.sens[i] = a.sensor[g];
    s.oidx[i] = a.owner_idx[i];
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

  // ---- frame setup: manifolds and frame constants per slot ----------------
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
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
    for (int c = 0; c < C; ++c) {
      const size_t t = (size_t)c * M + i;
      const size_t g = (size_t)w * plane + t;
      float* f = scr + t;
      const float act = a.slot_act[g];
      if (act == 0.f) {  // empty slot: every mask zero, nothing to solve
        f[F2_PM0 * plane] = f[F2_PM1 * plane] = 0.f;
        f[F2_SM0 * plane] = f[F2_SM1 * plane] = 0.f;
        a.o_touched[g] = 0.f;
        continue;
      }
      const int pc = a.partner[g];
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
      const float n_ax = o_ca * m.nx + o_sa * m.ny;
      const float n_ay = -o_sa * m.nx + o_ca * m.ny;
      f[F2_NAX * plane] = n_ax;
      f[F2_NAY * plane] = n_ay;
      if constexpr (kCcd) {  // the normal at the frame-start pose (kin00)
        cscr[t] = o_ca * n_ax - o_sa * n_ay;
        cscr[plane + t] = o_sa * n_ax + o_ca * n_ay;
      }
      float touch0 = 0.f;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float dxa = m.wax[p] - o_px, dya = m.way[p] - o_py;
        const float a_ax = o_ca * dxa + o_sa * dya;
        const float a_ay = -o_sa * dxa + o_ca * dya;
        const float dxb = m.wbx[p] - p_px, dyb = m.wby[p] - p_py;
        const float b_ax = p_ca * dxb + p_sa * dyb;
        const float b_ay = -p_sa * dxb + p_ca * dyb;
        const float pm = m.pmask[p] * act;
        f[(F2_AAX0 + p) * plane] = a_ax;
        f[(F2_AAY0 + p) * plane] = a_ay;
        f[(F2_BAX0 + p) * plane] = b_ax;
        f[(F2_BAY0 + p) * plane] = b_ay;
        f[(F2_PM0 + p) * plane] = pm;
        f[(F2_SM0 + p) * plane] = pm * solvable;
        touch0 = fmaxf(touch0, (m.sep[p] < kTouchSlop ? 1.f : 0.f) * pm);
        // kin00: anchor world positions at the frame-start pose
        f[(F2_WAX0 + p) * plane] = o_px + (o_ca * a_ax - o_sa * a_ay);
        f[(F2_WAY0 + p) * plane] = o_py + (o_sa * a_ax + o_ca * a_ay);
        f[(F2_WBX0 + p) * plane] = p_px + (p_ca * b_ax - p_sa * b_ay);
        f[(F2_WBY0 + p) * plane] = p_py + (p_sa * b_ax + p_ca * b_ay);
      }
      f[F2_FRIC * plane] = sqrtf(s.fric[i] * s.fric[pc]);
      f[F2_LAM0 * plane] = f[F2_LAM1 * plane] = 0.f;
      f[F2_REST * plane] = fmaxf(s.rest[i], s.rest[pc]);
      f[F2_IMB * plane] = s.invm[pb];
      f[F2_IIB * plane] = s.invi[pb];
      a.o_touched[g] = touch0;
    }
  }
  __syncthreads();

  // ---- substeps ------------------------------------------------------------
  for (int step = 0; step < a.substeps; ++step) {
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      // integrate (semi-implicit Euler)
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
      if constexpr (kCcd) {
        s.cab[n] = cosf(s.an[n]);
        s.sab[n] = sinf(s.an[n]);
      } else {
        s.dxx[n] = 0.f; s.dxy[n] = 0.f; s.dth[n] = 0.f;
      }
    }
    if constexpr (kCcd) {
      // TOI clamp: each row's factor, then each body's over its colliders
      __syncthreads();
      for (int i = threadIdx.x; i < M; i += blockDim.x)
        s.row[i] = 1.f - ccd_row_factor(s, a, scr, cscr, w, i, plane);
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
        }
        s.dxx[n] = 0.f; s.dxy[n] = 0.f; s.dth[n] = 0.f;
      }
    }
    for (int it = 0; it < a.iterations; ++it) {
      __syncthreads();
      for (int n = threadIdx.x; n < N; n += blockDim.x) {
        s.cab[n] = cosf(s.an[n]);
        s.sab[n] = sinf(s.an[n]);
      }
      __syncthreads();
      // Jacobi contact projection: every row reads the iteration-start pose
      for (int i = threadIdx.x; i < M; i += blockDim.x) {
        const int ob = s.cbody[i];
        const float ima = s.invm[ob], iia = s.invi[ob];
        const float o_px = s.px[ob], o_py = s.py[ob];
        const float o_ca = s.cab[ob], o_sa = s.sab[ob];
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int c = 0; c < C; ++c) {
          const size_t t = (size_t)c * M + i;
          float* f = scr + t;
          const float pm0 = f[F2_PM0 * plane], pm1 = f[F2_PM1 * plane];
          if (pm0 == 0.f && pm1 == 0.f) continue;
          const int pb = s.cbody[a.partner[(size_t)w * plane + t]];
          const float p_px = s.px[pb], p_py = s.py[pb];
          const float p_ca = s.cab[pb], p_sa = s.sab[pb];
          const float imb = f[F2_IMB * plane], iib = f[F2_IIB * plane];
          const float fric = f[F2_FRIC * plane];
          const float n_ax = f[F2_NAX * plane], n_ay = f[F2_NAY * plane];
          const float nx = o_ca * n_ax - o_sa * n_ay;
          const float ny = o_sa * n_ax + o_ca * n_ay;
          float cax = 0.f, cay = 0.f, dang = 0.f, nact = 0.f;
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const float a_ax = f[(F2_AAX0 + p) * plane];
            const float a_ay = f[(F2_AAY0 + p) * plane];
            const float b_ax = f[(F2_BAX0 + p) * plane];
            const float b_ay = f[(F2_BAY0 + p) * plane];
            const float rax = o_ca * a_ax - o_sa * a_ay;
            const float ray = o_sa * a_ax + o_ca * a_ay;
            const float rbx = p_ca * b_ax - p_sa * b_ay;
            const float rby = p_sa * b_ax + p_ca * b_ay;
            const float wax = o_px + rax, way = o_py + ray;
            const float wbx = p_px + rbx, wby = p_py + rby;
            float ax, ay, da, dlam;
            bool active;
            project_point(
                rax, ray, rbx, rby, wax, way, wbx, wby, nx, ny,
                [&] { return f[(F2_SM0 + p) * plane]; },
                [&](int k) {  // wax0, way0, wbx0, wby0
                  return f[(F2_WAX0 + 2 * k + p) * plane];
                },
                ima, iia, imb, iib, fric, a.alpha_t, ax, ay, da, dlam, active);
            cax = p ? cax + ax : ax;
            cay = p ? cay + ay : ay;
            dang = p ? dang + da : da;
            nact += active ? 1.f : 0.f;
            float* lam = f + (F2_LAM0 + p) * plane;
            *lam = (it ? *lam : 0.f) + dlam;
          }
          acc[0] += cax * ima;
          acc[1] += cay * ima;
          acc[2] += dang;
          acc[3] += nact;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) s.row[q * M + i] = acc[q];
      }
      if constexpr (kJ) {
        // Jacobi joints: summed at the iteration-start pose, like contacts
        if (!a.joint_colored)
          for (int n = threadIdx.x; n < N; n += blockDim.x)
            joint_sums<false>(s, a, w, n, -1, false);
      }
      __syncthreads();
      for (int n = threadIdx.x; n < N; n += blockDim.x) {
        float ab[4];
        to_body(s, M, n, ab);
        if constexpr (kJ) {
          if (!a.joint_colored) {
#pragma unroll
            for (int q = 0; q < 4; ++q) ab[q] = ab[q] + s.jrow[q * N + n];
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
      }
      if constexpr (kJ) {
        // coloured Gauss-Seidel: same-colour joints share no dynamic body,
        // so each pass applies exactly; the pose refreshes between passes
        if (a.joint_colored) {
          for (int color = 0; color < a.n_colors; ++color) {
            const bool last = color == a.n_colors - 1;
            for (int n = threadIdx.x; n < N; n += blockDim.x) {
              s.cab[n] = cosf(s.an[n]);
              s.sab[n] = sinf(s.an[n]);
            }
            __syncthreads();
            for (int n = threadIdx.x; n < N; n += blockDim.x)
              joint_sums<false>(s, a, w, n, color, last);
            __syncthreads();
            for (int n = threadIdx.x; n < N; n += blockDim.x) {
              const float cnt = fmaxf(s.jrow[3 * N + n], 1.f);
              // constraint upkeep, not depenetration: the raw max_dpos
              const float md = a.max_dpos_joint;
              const float jdx = fminf(fmaxf(s.jrow[n] / cnt, -md), md);
              const float jdy = fminf(fmaxf(s.jrow[N + n] / cnt, -md), md);
              const float jda =
                  fminf(fmaxf(s.jrow[2 * N + n] / cnt, -md), md);
              s.px[n] = s.px[n] + jdx;
              s.py[n] = s.py[n] + jdy;
              s.an[n] = s.an[n] + jda;
              s.dxx[n] = s.dxx[n] + jdx;
              s.dxy[n] = s.dxy[n] + jdy;
              s.dth[n] = s.dth[n] + jda;
            }
          }
        }
      }
    }
    __syncthreads();
    // velocity reconstruction (kinematic bodies keep their velocity)
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      const float kin = s.kin[n], nk = 1.f - kin;
      s.vx[n] = kin * s.vx[n] + nk * (s.vtx[n] + s.dxx[n] / h);
      s.vy[n] = kin * s.vy[n] + nk * (s.vty[n] + s.dxy[n] / h);
      s.om[n] = kin * s.om[n] + nk * (s.vtom[n] + s.dth[n] / h);
      s.cab[n] = cosf(s.an[n]);
      s.sab[n] = sinf(s.an[n]);
    }
    __syncthreads();
    // velocity pass: restitution + dynamic friction
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
      const int ob = s.cbody[i];
      const float ima = s.invm[ob], iia = s.invi[ob];
      const float o_px = s.px[ob], o_py = s.py[ob];
      const float o_ca = s.cab[ob], o_sa = s.sab[ob];
      const float vax = s.vx[ob], vay = s.vy[ob], oa = s.om[ob];
      const float v0ax = s.vtx[ob], v0ay = s.vty[ob], o0a = s.vtom[ob];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = 0; c < C; ++c) {
        const size_t t = (size_t)c * M + i;
        float* f = scr + t;
        const float pm[2] = {f[F2_PM0 * plane], f[F2_PM1 * plane]};
        if (pm[0] == 0.f && pm[1] == 0.f) continue;
        const size_t g = (size_t)w * plane + t;
        const int pb = s.cbody[a.partner[g]];
        const float p_px = s.px[pb], p_py = s.py[pb];
        const float p_ca = s.cab[pb], p_sa = s.sab[pb];
        const float vbx = s.vx[pb], vby = s.vy[pb], ob_ = s.om[pb];
        const float v0bx = s.vtx[pb], v0by = s.vty[pb], o0b = s.vtom[pb];
        const float imb = f[F2_IMB * plane], iib = f[F2_IIB * plane];
        const float fric = f[F2_FRIC * plane], rest = f[F2_REST * plane];
        const float n_ax = f[F2_NAX * plane], n_ay = f[F2_NAY * plane];
        const float nx = o_ca * n_ax - o_sa * n_ay;
        const float ny = o_sa * n_ax + o_ca * n_ay;
        float cbx = 0.f, cby = 0.f, dng = 0.f, nact = 0.f, tk = 0.f;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float a_ax = f[(F2_AAX0 + p) * plane];
          const float a_ay = f[(F2_AAY0 + p) * plane];
          const float b_ax = f[(F2_BAX0 + p) * plane];
          const float b_ay = f[(F2_BAY0 + p) * plane];
          const float rax = o_ca * a_ax - o_sa * a_ay;
          const float ray = o_sa * a_ax + o_ca * a_ay;
          const float rbx = p_ca * b_ax - p_sa * b_ay;
          const float rby = p_sa * b_ax + p_ca * b_ay;
          // the next substep's static-friction reference: positions do not
          // move after this pass
          f[(F2_WAX0 + p) * plane] = o_px + rax;
          f[(F2_WAY0 + p) * plane] = o_py + ray;
          f[(F2_WBX0 + p) * plane] = p_px + rbx;
          f[(F2_WBY0 + p) * plane] = p_py + rby;
          if constexpr (kCcd) {  // and the TOI's frame-start normal
            if (p == 0) {
              cscr[t] = nx;
              cscr[plane + t] = ny;
            }
          }
          float impx, impy, dd;
          bool active;
          const float* lamp = f + (F2_LAM0 + p) * plane;
          velocity_point(
              rax, ray, rbx, rby, nx, ny, vax, vay, oa, vbx, vby, ob_, v0ax,
              v0ay, o0a, v0bx, v0by, o0b, [&] { return *lamp; },
              [&] { return f[(F2_SM0 + p) * plane]; }, ima, iia, imb, iib,
              rest, fric, h, a.rest_threshold, impx, impy, dd, active);
          const float lam = *lamp;
          cbx = p ? cbx + impx : impx;
          cby = p ? cby + impy : impy;
          dng = p ? dng + dd : dd;
          nact += active ? 1.f : 0.f;
          tk = fmaxf(tk, (lam > 0.f ? 1.f : 0.f) * pm[p]);
        }
        acc[0] += -cbx * ima;
        acc[1] += -cby * ima;
        acc[2] += -dng;
        acc[3] += nact;
        a.o_touched[g] = fmaxf(a.o_touched[g], tk);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) s.row[q * M + i] = acc[q];
    }
    if constexpr (kJ) {
      // motors and joint damping, at the post-solve pose and velocities
      for (int n = threadIdx.x; n < N; n += blockDim.x)
        joint_sums<true>(s, a, w, n, -1, false);
    }
    __syncthreads();
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      float ab[4];
      to_body(s, M, n, ab);
      if constexpr (kJ) {
#pragma unroll
        for (int q = 0; q < 4; ++q) ab[q] = ab[q] + s.jrow[q * N + n];
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
    }
    __syncthreads();
  }

  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const long long g = w * N + n;
    a.o_posx[g] = s.px[n]; a.o_posy[g] = s.py[n]; a.o_ang[g] = s.an[n];
    a.o_velx[g] = s.vx[n]; a.o_vely[g] = s.vy[n]; a.o_angvel[g] = s.om[n];
  }
}

template <int V, bool kJ, bool kCcd>
int launch(const Frame2Args& a, cudaStream_t stream) {
  const size_t shmem = shared_bytes(a.N, a.M, V, kJ ? a.J : 0);
  cudaError_t err = cudaFuncSetAttribute(
      frame2_kernel<V, kJ, kCcd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  if (a.W > 0)
    frame2_kernel<V, kJ, kCcd><<<a.W, kThreads, shmem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int V, bool kJ>
int launch_ccd(const Frame2Args& a, cudaStream_t stream) {
  return a.ccd ? launch<V, kJ, true>(a, stream) : launch<V, kJ, false>(a, stream);
}

}  // namespace

SF_EXPORT(sf_frame2, Frame2Args)

extern "C" int sf_frame2_fields() { return F2_FIELDS; }

extern "C" long long sf_frame2_shared_bytes(int N, int M, int V, int J) {
  return (long long)shared_bytes(N, M, V, J);
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
