// Rigid-body dynamics of one physics substep for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the physics to XLA, which
// fuses it. In the port the same work (sim/tengine.py `rigid_body_plain`:
// `_fk`, the geoms, the joint-limit spring and `_mass_matrix_and_bias`) is
// about 1,100 small PyTorch kernels a substep, each reading and writing its
// intermediates in device memory. This kernel computes it in one launch, per
// env n, from the batch-last state:
//
//   gpos, gvel (G,3,N)    collision-sphere centres and velocities, world
//   jpos, axis_w (12,3,N) joint positions and axes, world
//   rbase (3,3,N)         base rotation
//   rhs0 (18,N)           tau_gen - bias: the joint-limit spring added to
//                         tau, less the RNEA bias (qdd = 0, gravity as the
//                         base's acceleration), in Featherstone base coords
//   B (4,3,6,N), Dinv (4,3,3,N), Sinv (6,6,N)
//                         the block-Schur factors of the CRBA mass matrix
//                         (joint damping and armature on the leg diagonal)
//
// Bound: memory. Per env it reads 230 floats (state, tau, damping, the 169
// dynamics parameters) and writes 711, 3.76 KB (30.8 MB at 8192 envs).
// Design:
// * One thread per (env, leg), 32 envs x 4 legs a block, the env fastest:
//   warp w of a block is leg w of 32 neighbouring envs, so every read and
//   write of a batch-last row is one coalesced 128-byte access, and every
//   branch on the leg is uniform in a warp. At 2048 envs that is 8,192
//   threads, not 2,048.
// * A leg's 3-body chain lives in registers: world kinematics, then the
//   body-frame velocities and RNEA forces on the way out, then one sweep
//   back that takes the RNEA forces, the composite inertias and the CRBA
//   columns up the chain together. Motion and force transforms are (E, r),
//   a rotation and a shift, as the plain version applies them.
// * The base's sums over the legs (the RNEA force, the composite inertia and
//   the Schur complement sum_l B^T Dinv B) go through shared memory; after
//   one barrier warp 0 inverts the Schur complement and warp 1 writes the
//   base rows of rhs0.
// * The model's constant tables (axes, origins, joint limits, gravity, the
//   geoms' offsets and their bodies) are one small read-only buffer read
//   with __ldg: every thread of a warp reads the same word.
//
// Numbers: the kernel gives the plain version's fp32 results bit for bit
// on the card. A rollout is chaotic, so any rounding difference in the
// physics grows within one 24-step rollout into different trajectories for
// some envs; bit-equal physics keeps a training run the plain version's.
// So every product is rounded on its own (`mul`: nvcc would contract a*b+c
// into one FMA), every sum adds its terms in the order in which torch.sum
// adds a small dimension on the card (`sum3`, `sum4`, `sum6`), and where
// the plain version multiplies dense 6x6 spatial matrices (the spatial
// inertias, X^T I X) so does the kernel, zero blocks included. What the
// kernel saves is the launches and the memory traffic of the
// intermediates, not arithmetic.
//
// The same source compiles as C++ for the host (g++ -x c++): there
// `rigid_body_host` runs both phases of every block in order, so that the
// CPU tests can run the kernel's arithmetic against the plain version (the
// CPU's torch.sum adds in other orders, so there the two agree to rounding).

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define RB_FN __device__ __forceinline__
#define RB_LDG(p) __ldg(p)
#else
#include <cmath>
#define RB_FN inline
#define RB_LDG(p) (*(p))
#endif

namespace {

constexpr int kLegs = 4;
constexpr int kDepth = 3;
constexpr int kEnvs = 32;                 // envs a block
constexpr int kThreads = kEnvs * kLegs;   // 128

// float table, offsets in floats
constexpr int kAxes = 0;                  // (4,3,3) joint axes, child frame
constexpr int kOrigins = 36;              // (4,3,3) joint origins, parent's
constexpr int kLower = 72;                // (12,) joint limits
constexpr int kUpper = 84;
constexpr int kGravity = 96;              // (3,)
constexpr int kGeomOffset = 99;           // (G,3) offsets in the body frame
// int table: body_start (14,), then the geoms sorted by body (G,)
constexpr int kBodyStart = 0;
constexpr int kGeomOrder = 14;

// the entries of a 6x6 that inv6_spd reads: rows 0-2 (18), then the
// lower-right block (9)
constexpr int kUsed = 27;
// per (leg, env) shared floats: the leg's base force, its composite
// inertia seen from the base, and B^T Dinv B (kUsed entries each)
constexpr int kUp = 0;
constexpr int kP = 6;
constexpr int kQ = kP + kUsed;
constexpr int kShared = kQ + kUsed;       // 60

struct In2 {                  // a (rows, N) input: p[r * sr + n * sn]
  const float* p;
  long long sr, sn;
};

struct Args {
  In2 pos, quat, q, lin, ang, qd, tau, kd;
  const float* mass;          // (13, N)
  const float* com;           // (13, 3, N)
  const float* inertia;       // (13, 3, 3, N)
  const float* table;
  const int* itable;
  float* gpos;
  float* gvel;
  float* jpos;
  float* axis_w;
  float* rbase;
  float* rhs0;
  float* B;
  float* Dinv;
  float* Sinv;
  int n_envs;
  float dt, armature, k_lim, k_lim_dt, d_lim;
};

// a product rounded on its own, never contracted into an FMA
RB_FN float mul(float a, float b) {
#ifdef __CUDACC__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

// torch.sum over a dimension of 3, 4 or 6 that is not the fastest-moving
// one, as the card's reduction kernel adds it (read on the card for every
// such shape of the plain version at 33 to 8192 envs): one thread an
// output, with 4 accumulators that take the terms in turn and are then
// added in order
RB_FN float sum3(float x0, float x1, float x2) { return (x0 + x1) + x2; }

RB_FN float sum4(float x0, float x1, float x2, float x3) {
  return ((x0 + x1) + x2) + x3;
}

RB_FN float sum6(const float x[6]) {
  return (((x[0] + x[4]) + (x[1] + x[5])) + x[2]) + x[3];
}

RB_FN float rd(const In2& x, int r, int n) {
  return RB_LDG(x.p + r * x.sr + n * x.sn);
}

RB_FN void cross3(const float a[3], const float b[3], float o[3]) {
  o[0] = mul(a[1], b[2]) - mul(a[2], b[1]);
  o[1] = mul(a[2], b[0]) - mul(a[0], b[2]);
  o[2] = mul(a[0], b[1]) - mul(a[1], b[0]);
}

RB_FN void mv3(const float M[9], const float v[3], float o[3]) {   // M v
#pragma unroll
  for (int i = 0; i < 3; ++i)
    o[i] = sum3(mul(M[3 * i], v[0]), mul(M[3 * i + 1], v[1]),
                mul(M[3 * i + 2], v[2]));
}

RB_FN void mtv3(const float M[9], const float v[3], float o[3]) {  // M^T v
#pragma unroll
  for (int i = 0; i < 3; ++i)
    o[i] = sum3(mul(M[i], v[0]), mul(M[3 + i], v[1]), mul(M[6 + i], v[2]));
}

RB_FN void mm3(const float A[9], const float B[9], float o[9]) {   // A B
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      o[3 * i + k] = sum3(mul(A[3 * i], B[k]), mul(A[3 * i + 1], B[3 + k]),
                          mul(A[3 * i + 2], B[6 + k]));
}

RB_FN void inv3(const float M[9], float o[9]) {   // explicit, as tmath.inv3
  const float a = M[0], b = M[1], c = M[2];
  const float d = M[3], e = M[4], f = M[5];
  const float g = M[6], h = M[7], i = M[8];
  const float A = mul(e, i) - mul(f, h), B = mul(c, h) - mul(b, i);
  const float C = mul(b, f) - mul(c, e), D = mul(f, g) - mul(d, i);
  const float E = mul(a, i) - mul(c, g), F = mul(c, d) - mul(a, f);
  const float G = mul(d, h) - mul(e, g), H = mul(b, g) - mul(a, h);
  const float I = mul(a, e) - mul(b, d);
  const float inv_det = 1.0f / ((mul(a, A) + mul(b, D)) + mul(c, G));
  o[0] = mul(A, inv_det); o[1] = mul(B, inv_det); o[2] = mul(C, inv_det);
  o[3] = mul(D, inv_det); o[4] = mul(E, inv_det); o[5] = mul(F, inv_det);
  o[6] = mul(G, inv_det); o[7] = mul(H, inv_det); o[8] = mul(I, inv_det);
}

RB_FN void transpose3(const float M[9], float o[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) o[3 * i + j] = M[3 * j + i];
}

RB_FN void skew3(const float v[3], float S[9]) {
  S[0] = 0.0f; S[1] = -v[2]; S[2] = v[1];
  S[3] = v[2]; S[4] = 0.0f; S[5] = -v[0];
  S[6] = -v[1]; S[7] = v[0]; S[8] = 0.0f;
}

RB_FN void quat_to_matrix(const Args& a, int n, float R[9]) {
  const float x = rd(a.quat, 0, n), y = rd(a.quat, 1, n);
  const float z = rd(a.quat, 2, n), w = rd(a.quat, 3, n);
  const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
  const float xy = mul(x, y), xz = mul(x, z), yz = mul(y, z);
  const float wx = mul(w, x), wy = mul(w, y), wz = mul(w, z);
  R[0] = 1.0f - mul(2.0f, yy + zz);
  R[1] = mul(2.0f, xy - wz);
  R[2] = mul(2.0f, xz + wy);
  R[3] = mul(2.0f, xy + wz);
  R[4] = 1.0f - mul(2.0f, xx + zz);
  R[5] = mul(2.0f, yz - wx);
  R[6] = mul(2.0f, xz - wy);
  R[7] = mul(2.0f, yz + wx);
  R[8] = 1.0f - mul(2.0f, xx + yy);
}

// rotation about a unit axis, as tmath.rodrigues: c 1 + s [a]x + (1-c) a a^T
RB_FN void rodrigues(const float ax[3], float qj, float R[9]) {
  const float c = cosf(qj), s = sinf(qj);
  const float om = 1.0f - c;
  float K[9];
  skew3(ax, K);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      R[3 * i + j] = (mul(c, i == j ? 1.0f : 0.0f) + mul(s, K[3 * i + j]))
                     + mul(om, mul(ax[i], ax[j]));
}

// the dense 6x6 spatial inertia of body b of env n, as _spatial_inertia:
// [[I + m Sc Sc^T, m Sc], [m Sc^T, m 1]], Sc = [com]x
RB_FN void spatial_inertia(const Args& a, int b, int n, float I6[36]) {
  const int N = a.n_envs;
  const float m = RB_LDG(a.mass + b * N + n);
  float c[3], Sc[9];
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = RB_LDG(a.com + (b * 3 + k) * N + n);
  skew3(c, Sc);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float ic = RB_LDG(a.inertia + ((b * 3 + i) * 3 + k) * N + n);
      const float scs = sum3(mul(Sc[3 * i], Sc[3 * k]),
                             mul(Sc[3 * i + 1], Sc[3 * k + 1]),
                             mul(Sc[3 * i + 2], Sc[3 * k + 2]));
      I6[6 * i + k] = ic + mul(m, scs);
      I6[6 * i + 3 + k] = mul(m, Sc[3 * i + k]);
      I6[6 * (3 + i) + k] = mul(m, Sc[3 * k + i]);
      I6[6 * (3 + i) + 3 + k] = mul(m, i == k ? 1.0f : 0.0f);
    }
}

// M x for a dense 6x6 M (tmath.mv)
RB_FN void mv6(const float M[36], const float x[6], float o[6]) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float t[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) t[j] = mul(M[6 * i + j], x[j]);
    o[i] = sum6(t);
  }
}

// X v for the joint's motion transform (_xm), E = Rj^T:
// (E w, E (u - r x w))
RB_FN void motion_down(const float Rj[9], const float r[3], const float w[3],
                       const float u[3], float wo[3], float uo[3]) {
  float rw[3], t[3];
  mtv3(Rj, w, wo);
  cross3(r, w, rw);
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = u[k] - rw[k];
  mtv3(Rj, t, uo);
}

// X^T f for the joint's force transform (_xfT): (E^T n + r x F', F'),
// F' = E^T F, in place
RB_FN void force_up(const float Rj[9], const float r[3], float f[6]) {
  float n[3], F[3], rF[3];
  mv3(Rj, f + 3, F);
  mv3(Rj, f, n);
  cross3(r, F, rF);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f[k] = n[k] + rF[k];
    f[3 + k] = F[k];
  }
}

// the dense 6x6 motion transform of the joint, as _xmat:
// [[E, 0], [-E [r]x, E]], E = Rj^T
struct Xmat {
  float E[9];
  float L[9];       // -E [r]x
  RB_FN float at(int j, int k) const {
    if (j < 3) return k < 3 ? E[3 * j + k] : 0.0f;
    return k < 3 ? L[3 * (j - 3) + k] : E[3 * (j - 3) + (k - 3)];
  }
};

RB_FN Xmat xmat(const float Rj[9], const float r[3]) {
  Xmat X;
  float Sr[9], ES[9];
  transpose3(Rj, X.E);
  skew3(r, Sr);
  mm3(X.E, Sr, ES);
#pragma unroll
  for (int k = 0; k < 9; ++k) X.L[k] = -ES[k];
  return X;
}

// out = X^T (I X) (tmath.mtm of tmath.mm), dense, a column at a time; with
// kAll false only the entries that inv6_spd reads
template <bool kAll>
RB_FN void congruence(const Xmat& X, const float I[36], float out[36]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float col[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float t[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) t[j] = mul(I[6 * i + j], X.at(j, k));
      col[i] = sum6(t);
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      if (!kAll && j >= 3 && k < 3) continue;
      float t[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) t[i] = mul(X.at(i, j), col[i]);
      out[6 * j + k] = sum6(t);
    }
  }
}

// sum_j S_j F_j for S = (axis, 0): torch.sum(Sax * F, dim=-2)
RB_FN float sdot(const float ax[3], const float F[6]) {
  const float t[6] = {mul(ax[0], F[0]), mul(ax[1], F[1]), mul(ax[2], F[2]),
                      mul(0.0f, F[3]), mul(0.0f, F[4]), mul(0.0f, F[5])};
  return sum6(t);
}

// F = I S for S = (axis, 0): tmath.mv(Icc, Sax)
RB_FN void inertia_col(const float I[36], const float ax[3], float F[6]) {
  const float S[6] = {ax[0], ax[1], ax[2], 0.0f, 0.0f, 0.0f};
  mv6(I, S, F);
}

// f = I a + v x* (I v): a body's RNEA force
RB_FN void rnea_force(const float I[36], const float v[6], const float acc[6],
                      float f[6]) {
  float Ia[6], Iv[6], x1[3], x2[3], x3[3];
  mv6(I, acc, Ia);
  mv6(I, v, Iv);
  cross3(v, Iv, x1);
  cross3(v + 3, Iv + 3, x2);
  cross3(v, Iv + 3, x3);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f[k] = Ia[k] + (x1[k] + x2[k]);
    f[3 + k] = Ia[3 + k] + x3[k];
  }
}

// the 6x6 index of the u-th entry that inv6_spd reads
RB_FN int used_at(int u) {
  return u < 18 ? u : 6 * (3 + (u - 18) / 3) + 3 + (u - 18) % 3;
}

// the collision sphere g of a body: centre p + R off, velocity v + w x arm
RB_FN void geom(const Args& a, int g, int n, const float R[9],
                const float p[3], const float w[3], const float v[3]) {
  const int N = a.n_envs;
  float off[3], arm[3], wa[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    off[k] = RB_LDG(a.table + kGeomOffset + 3 * g + k);
  mv3(R, off, arm);
  cross3(w, arm, wa);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.gpos[(g * 3 + k) * N + n] = p[k] + arm[k];
    a.gvel[(g * 3 + k) * N + n] = v[k] + wa[k];
  }
}

RB_FN void store3(float* out, int row, int N, int n, const float x[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) out[(row * 3 + k) * N + n] = x[k];
}

// the base's body-frame velocity (R^T w, R^T v) and acceleration
// (0, -R^T g)
RB_FN void base_motion(const Args& a, int n, const float R0[9], float v[6],
                       float acc[6]) {
  float angw[3], linw[3], gw[3], gb[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    angw[k] = rd(a.ang, k, n);
    linw[k] = rd(a.lin, k, n);
    gw[k] = RB_LDG(a.table + kGravity + k);
  }
  mtv3(R0, angw, v);
  mtv3(R0, linw, v + 3);
  mtv3(R0, gw, gb);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    acc[k] = 0.0f;
    acc[3 + k] = -gb[k];
  }
}

// Phase 1: leg `l` of env `n`. Writes the leg's outputs and its shares of
// the base's sums into `sh` (kShared floats, stride kEnvs).
RB_FN void leg_phase(const Args& a, int n, int l, float* sh) {
  const int N = a.n_envs;
  const float* tab = a.table;
  float R0[9], pos[3], angw[3], linw[3];
  quat_to_matrix(a, n, R0);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pos[k] = rd(a.pos, k, n);
    angw[k] = rd(a.ang, k, n);
    linw[k] = rd(a.lin, k, n);
  }
  if (l == 2) {
#pragma unroll
    for (int k = 0; k < 9; ++k) a.rbase[k * N + n] = R0[k];
  }
  // the base's geoms, dealt round the four legs
  {
    const int g0 = RB_LDG(a.itable + kBodyStart);
    const int g1 = RB_LDG(a.itable + kBodyStart + 1);
    for (int i = g0 + l; i < g1; i += kLegs)
      geom(a, RB_LDG(a.itable + kGeomOrder + i), n, R0, pos, angw, linw);
  }

  // world kinematics carried down the chain (_fk)
  float Rp[9], pp[3], wp[3], vp[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) Rp[k] = R0[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pp[k] = pos[k];
    wp[k] = angw[k];
    vp[k] = linw[k];
  }
  // body-frame velocity and acceleration (gravity as the base's)
  float v[6], acc[6];
  base_motion(a, n, R0, v, acc);

  float Rj[kDepth][9], f[kDepth][6], tau_tot[kDepth], damp[kDepth];
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    const int j = kDepth * l + d;
    const int b = 1 + j;
    float ax[3], org[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ax[k] = RB_LDG(tab + kAxes + 3 * j + k);
      org[k] = RB_LDG(tab + kOrigins + 3 * j + k);
    }
    const float qj = rd(a.q, j, n);
    const float qdj = rd(a.qd, j, n);
    rodrigues(ax, qj, Rj[d]);

    // world: r_w = Rp org, axis_w = Rp ax, Rc = Rp Rj
    {
      float rw[3], aw[3], Rc[9], pc[3], wc[3], vc[3], wr[3];
      mv3(Rp, org, rw);
      mv3(Rp, ax, aw);
      mm3(Rp, Rj[d], Rc);
      cross3(wp, rw, wr);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        pc[k] = pp[k] + rw[k];
        wc[k] = wp[k] + mul(aw[k], qdj);
        vc[k] = vp[k] + wr[k];
      }
      store3(a.jpos, j, N, n, pc);
      store3(a.axis_w, j, N, n, aw);
      const int g0 = RB_LDG(a.itable + kBodyStart + b);
      const int g1 = RB_LDG(a.itable + kBodyStart + b + 1);
      for (int i = g0; i < g1; ++i)
        geom(a, RB_LDG(a.itable + kGeomOrder + i), n, Rc, pc, wc, vc);
#pragma unroll
      for (int k = 0; k < 9; ++k) Rp[k] = Rc[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        pp[k] = pc[k];
        wp[k] = wc[k];
        vp[k] = vc[k];
      }
    }

    // body frame: v = X v_p + S qd; a = X a_p + v x (S qd), S = (axis, 0)
    {
      float w2[3], u2[3], wa2[3], ua2[3], sq[3], zq[3], c1[3], c2[3], c3[3];
      motion_down(Rj[d], org, v, v + 3, w2, u2);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        sq[k] = mul(ax[k], qdj);
        zq[k] = mul(0.0f, qdj);
        w2[k] = w2[k] + sq[k];
        u2[k] = u2[k] + zq[k];
      }
      motion_down(Rj[d], org, acc, acc + 3, wa2, ua2);
      cross3(w2, sq, c1);
      cross3(w2, zq, c2);
      cross3(u2, sq, c3);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        v[k] = w2[k];
        v[3 + k] = u2[k];
        acc[k] = wa2[k] + c1[k];
        acc[3 + k] = ua2[k] + (c2[k] + c3[k]);
      }
    }

    // RNEA force: f = I a + v x* (I v)
    {
      float I6[36];
      spatial_inertia(a, b, n, I6);
      rnea_force(I6, v, acc, f[d]);
    }

    // joint-limit spring, implicit in the damping
    {
      const float lo = RB_LDG(tab + kLower + j) - qj;
      const float hi = qj - RB_LDG(tab + kUpper + j);
      const float viol_lo = lo < 0.0f ? 0.0f : lo;
      const float viol_hi = hi < 0.0f ? 0.0f : hi;
      const float in_viol = (viol_lo > 0.0f || viol_hi > 0.0f) ? 1.0f : 0.0f;
      tau_tot[d] = (rd(a.tau, j, n) + mul(a.k_lim, viol_lo - viol_hi))
                   - mul(mul(a.k_lim_dt, qdj), in_viol);
      damp[d] = rd(a.kd, j, n) + mul(in_viol, a.d_lim);
    }
  }

  // one sweep back up the chain: RNEA forces, composite inertias, and the
  // CRBA columns F_d = Icc_d S_d carried up to the base
  float Fc[kDepth][6], D[9], Icc[36];
#pragma unroll
  for (int d = kDepth - 1; d >= 0; --d) {
    const int j = kDepth * l + d;
    float ax[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) ax[k] = RB_LDG(tab + kAxes + 3 * j + k);
    a.rhs0[(6 + j) * N + n] = tau_tot[d] - sdot(ax, f[d]);
    if (d > 0) {
      float org[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) org[k] = RB_LDG(tab + kOrigins + 3 * j + k);
      force_up(Rj[d], org, f[d]);
#pragma unroll
      for (int k = 0; k < 6; ++k) f[d - 1][k] = f[d - 1][k] + f[d][k];
    }
    if (d == kDepth - 1) {
      spatial_inertia(a, 1 + j, n, Icc);
    } else {
      float orgc[3], T[36], I6[36];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        orgc[k] = RB_LDG(tab + kOrigins + 3 * (j + 1) + k);
      const Xmat X = xmat(Rj[d + 1], orgc);
      congruence<true>(X, Icc, T);
      spatial_inertia(a, 1 + j, n, I6);
#pragma unroll
      for (int k = 0; k < 36; ++k) Icc[k] = I6[k] + T[k];
      // the columns below carried up one joint
#pragma unroll
      for (int dd = d + 1; dd < kDepth; ++dd) {
        force_up(Rj[d + 1], orgc, Fc[dd]);
        D[3 * dd + d] = sdot(ax, Fc[dd]);
        D[3 * d + dd] = D[3 * dd + d];
      }
    }
    inertia_col(Icc, ax, Fc[d]);
    D[4 * d] = sdot(ax, Fc[d]);
  }

  // up to the base through joint 0
  {
    float org0[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      org0[k] = RB_LDG(tab + kOrigins + 3 * (kDepth * l) + k);
    force_up(Rj[0], org0, f[0]);
#pragma unroll
    for (int k = 0; k < 6; ++k) sh[(kUp + k) * kEnvs] = f[0][k];
    const Xmat X = xmat(Rj[0], org0);
    float P[36];
    congruence<false>(X, Icc, P);
#pragma unroll
    for (int u = 0; u < kUsed; ++u) sh[(kP + u) * kEnvs] = P[used_at(u)];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      force_up(Rj[0], org0, Fc[d]);
#pragma unroll
      for (int k = 0; k < 6; ++k)
        a.B[((l * kDepth + d) * 6 + k) * N + n] = Fc[d][k];
    }
  }

  // D + diag(damping dt + armature), its inverse, and B^T (Dinv B)
  {
    float Di[9];
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      const float diag = mul(damp[i], a.dt) + a.armature;
#pragma unroll
      for (int k = 0; k < kDepth; ++k)
        D[3 * i + k] = D[3 * i + k] + mul(i == k ? 1.0f : 0.0f, diag);
    }
    inv3(D, Di);
#pragma unroll
    for (int k = 0; k < 9; ++k) a.Dinv[(l * 9 + k) * N + n] = Di[k];
    float DB[kDepth][6];
#pragma unroll
    for (int i = 0; i < kDepth; ++i)
#pragma unroll
      for (int k = 0; k < 6; ++k)
        DB[i][k] = sum3(mul(Di[3 * i], Fc[0][k]), mul(Di[3 * i + 1], Fc[1][k]),
                        mul(Di[3 * i + 2], Fc[2][k]));
#pragma unroll
    for (int u = 0; u < kUsed; ++u) {
      const int e = used_at(u), r = e / 6, c = e % 6;
      sh[(kQ + u) * kEnvs] = sum3(mul(Fc[0][r], DB[0][c]),
                                  mul(Fc[1][r], DB[1][c]),
                                  mul(Fc[2][r], DB[2][c]));
    }
  }
}

RB_FN float sum_legs(const float* sh, int field) {
  // sh points at leg 0's slot of this env; legs are kShared * kEnvs apart
  return sum4(sh[field * kEnvs], sh[(kShared + field) * kEnvs],
              sh[(2 * kShared + field) * kEnvs],
              sh[(3 * kShared + field) * kEnvs]);
}

// Phase 2, after the barrier: warp 0 inverts the Schur complement
// S = A - sum_l B^T Dinv B, warp 1 writes the base rows of rhs0.
RB_FN void base_phase(const Args& a, int n, int l, const float* sh) {
  const int N = a.n_envs;
  if (l == 0) {
    float I6[36], S[36];
    spatial_inertia(a, 0, n, I6);
#pragma unroll
    for (int u = 0; u < kUsed; ++u) {
      const int e = used_at(u);
      S[e] = (I6[e] + sum_legs(sh, kP + u)) - sum_legs(sh, kQ + u);
    }
    // inv6_spd of tmath: S = [[P, Q], [Q^T, R]] by the 3x3 block Schur
    float P[9], Q[9], R[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        P[3 * i + j] = S[6 * i + j];
        Q[3 * i + j] = S[6 * i + 3 + j];
        R[3 * i + j] = S[6 * (3 + i) + 3 + j];
      }
    float Pi[9], PiQ[9], Qt[9], QtPiQ[9], T[9], Ti[9], PiQt[9], M[9];
    float tl[9], tr[9];
    inv3(P, Pi);
    mm3(Pi, Q, PiQ);
    transpose3(Q, Qt);
    mm3(Qt, PiQ, QtPiQ);
#pragma unroll
    for (int k = 0; k < 9; ++k) T[k] = R[k] - QtPiQ[k];
    inv3(T, Ti);
    transpose3(PiQ, PiQt);
    mm3(Ti, PiQt, M);
    mm3(PiQ, M, tl);
    mm3(PiQ, Ti, tr);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        a.Sinv[(6 * i + j) * N + n] = Pi[3 * i + j] + tl[3 * i + j];
        a.Sinv[(6 * i + 3 + j) * N + n] = -tr[3 * i + j];
        a.Sinv[(6 * (3 + j) + i) * N + n] = -tr[3 * i + j];
        a.Sinv[(6 * (3 + i) + 3 + j) * N + n] = Ti[3 * i + j];
      }
  } else if (l == 1) {
    // f_base = I a_base + v_base x* (I v_base) + sum_l X_0^T f_0
    float I6[36], R0[9], v[6], acc[6], f[6];
    spatial_inertia(a, 0, n, I6);
    quat_to_matrix(a, n, R0);
    base_motion(a, n, R0, v, acc);
    rnea_force(I6, v, acc, f);
#pragma unroll
    for (int k = 0; k < 6; ++k)
      a.rhs0[k * N + n] = 0.0f - (f[k] + sum_legs(sh, kUp + k));
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(kThreads)
rigid_body_kernel(const __grid_constant__ Args a) {
  __shared__ float sh[kLegs * kShared * kEnvs];
  const int lane = threadIdx.x % kEnvs;
  const int l = threadIdx.x / kEnvs;
  const int n = blockIdx.x * kEnvs + lane;
  const bool live = n < a.n_envs;
  if (live) leg_phase(a, n, l, sh + l * kShared * kEnvs + lane);
  __syncthreads();
  if (live) base_phase(a, n, l, sh + lane);
}
#endif

Args make_args(const void* const* ptrs, const long long* strides, int n_envs,
               const float* scalars) {
  Args a;
  In2* ins[8] = {&a.pos, &a.quat, &a.q, &a.lin, &a.ang, &a.qd, &a.tau, &a.kd};
  for (int i = 0; i < 8; ++i) {
    ins[i]->p = static_cast<const float*>(ptrs[i]);
    ins[i]->sr = strides[2 * i];
    ins[i]->sn = strides[2 * i + 1];
  }
  a.mass = static_cast<const float*>(ptrs[8]);
  a.com = static_cast<const float*>(ptrs[9]);
  a.inertia = static_cast<const float*>(ptrs[10]);
  a.table = static_cast<const float*>(ptrs[11]);
  a.itable = static_cast<const int*>(ptrs[12]);
  float** outs[9] = {&a.gpos, &a.gvel, &a.jpos, &a.axis_w, &a.rbase, &a.rhs0,
                     &a.B, &a.Dinv, &a.Sinv};
  for (int i = 0; i < 9; ++i)
    *outs[i] = static_cast<float*>(const_cast<void*>(ptrs[13 + i]));
  a.n_envs = n_envs;
  a.dt = scalars[0];
  a.armature = scalars[1];
  a.k_lim = scalars[2];
  a.k_lim_dt = scalars[3];
  a.d_lim = scalars[4];
  return a;
}

}  // namespace

// ptrs: the 8 (rows, N) inputs pos, quat, q, lin, ang, qd, tau, kd (strides
// in `strides`, two a tensor, in floats), mass, com, inertia (contiguous),
// the float and int tables, then the 9 outputs gpos, gvel, jpos, axis_w,
// rbase, rhs0, B, Dinv, Sinv (contiguous). scalars: dt, armature, the
// joint-limit stiffness k, k dt, and k dt + the joint-limit damping.
#ifdef __CUDACC__
extern "C" int rigid_body_launch(const void* const* ptrs,
                                 const long long* strides, int n_envs,
                                 const float* scalars, void* stream) {
  if (n_envs == 0) return 0;
  const Args a = make_args(ptrs, strides, n_envs, scalars);
  const int blocks = (n_envs + kEnvs - 1) / kEnvs;
  rigid_body_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
#else
extern "C" int rigid_body_host(const void* const* ptrs,
                               const long long* strides, int n_envs,
                               const float* scalars) {
  const Args a = make_args(ptrs, strides, n_envs, scalars);
  static float sh[kLegs * kShared * kEnvs];
  for (int blk = 0; blk * kEnvs < n_envs; ++blk) {
    for (int t = 0; t < kThreads; ++t) {
      const int lane = t % kEnvs, l = t / kEnvs, n = blk * kEnvs + lane;
      if (n < n_envs) leg_phase(a, n, l, sh + l * kShared * kEnvs + lane);
    }
    for (int t = 0; t < kThreads; ++t) {
      const int lane = t % kEnvs, l = t / kEnvs, n = blk * kEnvs + lane;
      if (n < n_envs) base_phase(a, n, l, sh + lane);
    }
  }
  return 0;
}
#endif
