// Kernel K2a: one whole warm AL-SQP solve per scenario, in one launch.
//
// Replaces the flagship specialization of the TPU kernel
// mpc_local_planner_tpu/ops/fused_al_sqp_pallas.py :: _fused_kernel
// (model "simple_car", forward differences, one footprint disc at the pose,
// static point and circle obstacle slots, minimum time on a uniform shared
// variable dt, no terminal ball) and computes what it computes, per scenario:
//   per SQP iteration: the closed-form forward-difference linearization, the
//     terminal P/p, the stage AL gradients and Gauss-Newton Hessians streamed
//     into the backward Riccati sweep (2x2 Quu inverse, K/kff tape), the free
//     dtau stage, the forward rollout, the NaN quarantine, the dt trust cap,
//     the candidate line search on the AL merit (alpha = 0 candidate last,
//     first of equal merits wins) and the reg update;
//   per AL phase: the dual update with conditional rho growth and the
//     best-feasible snapshot;
//   at the end: the final selection and the minimum-time cost.
// The plain PyTorch version of the same math is
// ops/fused_al_sqp_cuda.py :: fused_solve_plain.
//
// Bound on an H100: operations. Per scenario at N = 30, M = 8 the kernel
// reads 784 and writes 735 values (6 KB in float), but the solve needs about
// 0.79 MFLOP at a 3x4 budget with 3 candidates (k2a_flops in the wrapper
// counts them from this code, the Riccati step and the rollout on the
// structure of Fz, Gz and the stage Hessian): at B = 4096 that is 3.2 GFLOP,
// 48 us at the card's 67 TFLOP/s float32 peak, against 7 us for the bytes.
// The arithmetic is small-matrix algebra with no product a tensor core could
// take. This kernel runs the step as dense 6x6 products over the structural
// zeros and ones (about four times the step's operations, 1.7 times the
// whole solve's); folding them as the TPU kernel does is left for later.
//
// Design: one thread per scenario, the simplest layout that is right.
// Each thread walks its whole solve: P and p in registers, the K/kff tape,
// the step (dxs, dus) and the best-feasible snapshot in local memory (which
// the hardware interleaves across the threads of a warp), the primal and
// the duals updated in place in the output tensors after a first copy from
// the inputs. Inputs and outputs keep the wrapper's (B, N, ...) layout, so
// neighbouring threads read about 6 KB apart and the loads are not
// coalesced. Blocks are one warp (32 threads), so a batch of 4096 spreads
// over 128 of the 132 SMs; with one warp per SM nothing hides the latency of
// the dependent chain, so the kernel runs far above its bound. A
// warp-cooperative or stage-parallel design is the next step. The kernel is
// a template over float and double, so that the card can check the
// algorithm in f64, free of f32 noise.
//
// N, M and the number of line-search candidates are runtime arguments up to
// MAX_N, MAX_M and MAX_ALPHAS; the entry points refuse larger values.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream and returns cudaGetLastError() (0 on success).

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int NX = 3;
constexpr int NU = 2;
constexpr int NA = 6;  // z = [dx (3), du_prev (2), dtau]
constexpr int MAX_N = 64;
constexpr int MAX_M = 16;
constexpr int MAX_ALPHAS = 16;
constexpr int THREADS = 32;
constexpr double BIG = 1.0e6;   // geometry.obstacles.BIG_DISTANCE
constexpr double EPS = 1.0e-12; // geometry.distances._EPS (safe norm)
constexpr double PI = 3.141592653589793;
constexpr double TWO_PI = 6.283185307179586;

}  // namespace

// Static problem and solver constants, by value (doubles; the kernel rounds
// them to its working type, as the plain version's tensors do).
struct K2aParams {
  int N, M, n_al, n_sqp, n_alpha;
  int xf_fixed[3];
  double wheelbase, fp_radius, min_dist;
  double lo_u[2], hi_u[2], lo_r[2], hi_r[2];  // rate limits sanitized to +-BIG
  double dt_min, dt_max, dt_lo, dt_hi;
  double alphas[MAX_ALPHAS];
  double dt_trust_frac, rho_growth, rho_max;
  double reg0, reg_shrink, reg_grow, reg_min, reg_max;
  double viol_decrease_req, tol_eq, tol_ineq;
};

namespace {

template <typename T>
struct K2aArgs {
  // inputs
  const T *xs_i, *us_i, *dt_i, *xf, *u_prev;
  const T *oc, *orad;               // circle slots: centers (B,M,2), radii (B,M)
  const unsigned char* omask;       // (B,M) bool
  const T *ld_i, *lt_i, *mo_i, *mr_i, *mb_i, *md_i, *mball_i, *rho_i;
  // outputs: the working state, updated in place
  T *xs, *us, *dt, *ld, *lt, *mo, *mr, *mb, *md, *mball, *rho;
  T *cost, *eq, *ineq;
  unsigned char* conv;
  int B;
};

template <typename T> __device__ __forceinline__ T tiny();
template <> __device__ __forceinline__ float tiny<float>() { return FLT_MIN; }
template <> __device__ __forceinline__ double tiny<double>() { return DBL_MIN; }
template <typename T> __device__ __forceinline__ T largest();
template <> __device__ __forceinline__ float largest<float>() { return FLT_MAX; }
template <> __device__ __forceinline__ double largest<double>() { return DBL_MAX; }

// max / min that keep a NaN, like torch.maximum / torch.minimum
template <typename T> __device__ __forceinline__ T vmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T vmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T hinge(T t) { return vmax(T(0), t); }
template <typename T> __device__ __forceinline__ T clip(T v, T lo, T hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// AL curvature weight of an exactly penalized linear inequality: the
// Hessian of max(0, t)^2 / (2 rho) with the 0.5 tie subgradient of maximum,
// so an exactly active row (t == 0) weighs rho / 4.
template <typename T> __device__ __forceinline__ T hinge_w(T t, T rho) {
  const T s = t > T(0) ? T(1) : (t == T(0) ? T(0.5) : T(0));
  return rho * s * s;
}

// theta wrap to [-pi, pi) with torch.remainder's (jnp.mod's) sign rule
template <typename T> __device__ __forceinline__ T wrap(T th) {
  T m = fmod(th + T(PI), T(TWO_PI));
  if (m != T(0) && m < T(0)) m += T(TWO_PI);
  return m - T(PI);
}

template <typename T>
struct Lane {
  int N, M;
  T wb, fp_r, min_dist, dt_min, dt_max, dt_lo, dt_hi;
  T lo_u[NU], hi_u[NU], lo_r[NU], hi_r[NU];
  bool fixed[NX];
  const T *xf, *u_prev, *oc, *orad;
  const unsigned char* omask;
  T *xs, *us, *ld, *lt, *mo, *mr, *mb, *md, *mball;
  T dt, rho;
  // the step, the gain tape and the best-feasible snapshot (local memory)
  T dxs[MAX_N + 1][NX], dus[MAX_N][NU], dtau;
  T Kt[MAX_N][NU][NA], kft[MAX_N][NU];
  T bxs[MAX_N + 1][NX], bus[MAX_N][NU];

  __device__ __forceinline__ void x_at(int k, T x[NX]) const {
    for (int i = 0; i < NX; ++i) x[i] = xs[k * NX + i];
  }
  __device__ __forceinline__ void u_at(int k, T u[NU]) const {
    for (int i = 0; i < NU; ++i) u[i] = us[k * NU + i];
  }
  // u_{k-1}, with u_{-1} = the scenario's u_prev
  __device__ __forceinline__ void uprev_at(int k, T u[NU]) const {
    for (int i = 0; i < NU; ++i) u[i] = k == 0 ? u_prev[i] : us[(k - 1) * NU + i];
  }

  // simple car f(x, u); the theta column of Jx; Ju
  __device__ __forceinline__ void dyn(const T x[NX], const T u[NU], T f[NX], T jx[2],
                                      T ju[NX][NU]) const {
    const T c = cos(x[2]), s = sin(x[2]), t = tan(u[1]), v = u[0];
    f[0] = v * c;
    f[1] = v * s;
    f[2] = v * t / wb;
    jx[0] = -v * s;
    jx[1] = v * c;
    ju[0][0] = c;
    ju[0][1] = T(0);
    ju[1][0] = s;
    ju[1][1] = T(0);
    ju[2][0] = t / wb;
    ju[2][1] = v * (T(1) + t * t) / wb;
  }

  // forward-difference defect c = wrap(x_k + dt f(x_k, u_k) - x_{k+1})
  __device__ __forceinline__ void defect_value(const T xk[NX], const T uk[NU],
                                               const T xk1[NX], T dtv, T c[NX]) const {
    T f[NX], jx[2], ju[NX][NU];
    dyn(xk, uk, f, jx, ju);
    c[0] = xk[0] + dtv * f[0] - xk1[0];
    c[1] = xk[1] + dtv * f[1] - xk1[1];
    c[2] = wrap(xk[2] + dtv * f[2] - xk1[2]);
  }

  // the augmented transition of stage k at the current iterate:
  //   Fz = [[F, 0, m], [0, 0, 0], [0, 0, 1]], Gz = [[G], [I], [0]], rz = [c; 0]
  // with F = I + dt Jx, G = dt Ju, m = f, c the defect (E = -I exactly)
  __device__ __forceinline__ void transition(int k, T Fz[NA][NA], T Gz[NA][NU],
                                             T rz[NA]) const {
    T xk[NX], uk[NU], xk1[NX], f[NX], jx[2], ju[NX][NU];
    x_at(k, xk);
    u_at(k, uk);
    x_at(k + 1, xk1);
    dyn(xk, uk, f, jx, ju);
    rz[0] = xk[0] + dt * f[0] - xk1[0];
    rz[1] = xk[1] + dt * f[1] - xk1[1];
    rz[2] = wrap(xk[2] + dt * f[2] - xk1[2]);
    rz[3] = rz[4] = rz[5] = T(0);
    for (int i = 0; i < NA; ++i)
      for (int j = 0; j < NA; ++j) Fz[i][j] = T(0);
    for (int i = 0; i < NX; ++i) {
      Fz[i][i] = T(1);
      Fz[i][NA - 1] = f[i];
      for (int j = 0; j < NU; ++j) Gz[i][j] = dt * ju[i][j];
    }
    Fz[0][2] = dt * jx[0];
    Fz[1][2] = dt * jx[1];
    Fz[NA - 1][NA - 1] = T(1);
    Gz[3][0] = T(1);
    Gz[3][1] = T(0);
    Gz[4][0] = T(0);
    Gz[4][1] = T(1);
    Gz[5][0] = Gz[5][1] = T(0);
  }

  // obstacle row j at pose x: g = min_dist - d (d = the disc's distance to
  // the slot, BIG on a masked slot) and the position gradient of g
  __device__ __forceinline__ T obstacle_g(const T x[NX], int j, T& gx, T& gy) const {
    const T ex = x[0] - oc[2 * j], ey = x[1] - oc[2 * j + 1];
    const T dn = sqrt(ex * ex + ey * ey + T(EPS));
    const T d = (omask[j] ? dn - orad[j] : T(BIG)) - fp_r;
    gx = -(ex / dn);
    gy = -(ey / dn);
    return min_dist - d;
  }

  // rows of the stage inequalities that are linear: rate (4) and box (4)
  __device__ __forceinline__ void rate_g(const T u[NU], const T up[NU], T dtv, T g[4]) const {
    const T du0 = u[0] - up[0], du1 = u[1] - up[1];
    g[0] = du0 - hi_r[0] * dtv;
    g[1] = du1 - hi_r[1] * dtv;
    g[2] = lo_r[0] * dtv - du0;
    g[3] = lo_r[1] * dtv - du1;
  }
  __device__ __forceinline__ void box_g(const T u[NU], T g[4]) const {
    g[0] = u[0] - hi_u[0];
    g[1] = u[1] - hi_u[1];
    g[2] = lo_u[0] - u[0];
    g[3] = lo_u[1] - u[1];
  }

  // exact AL gradient (hz, hu) and hybrid Gauss-Newton Hessian blocks of the
  // stage-k merit over z = [x, u_prev, dt] and v = u
  __device__ __forceinline__ void stage_grad_hess(int k, T hz[NA], T hu[NU], T Hzz[NA][NA],
                                                  T Hzu[NA][NU], T Huu[NU][NU]) const {
    for (int i = 0; i < NA; ++i) {
      hz[i] = T(0);
      for (int j = 0; j < NA; ++j) Hzz[i][j] = T(0);
      for (int j = 0; j < NU; ++j) Hzu[i][j] = T(0);
    }
    for (int i = 0; i < NU; ++i) {
      hu[i] = T(0);
      for (int j = 0; j < NU; ++j) Huu[i][j] = T(0);
    }
    T xk[NX], uk[NU], up[NU];
    x_at(k, xk);
    u_at(k, uk);
    uprev_at(k, up);
    hz[5] = T(1);  // minimum time: the stage cost dt has a unit gradient

    // obstacles at x_k with multiplier row k-1 (inactive at k = 0); the
    // Gauss-Newton weight is crisp: rho where mu + rho g > 0
    if (k > 0) {
      const T* mu_row = mo + (k - 1) * M;
      for (int j = 0; j < M; ++j) {
        T gx, gy;
        const T g = obstacle_g(xk, j, gx, gy);
        const T t = mu_row[j] + rho * g;
        const T a = hinge(t);
        const T aw = t > T(0) ? rho : T(0);
        hz[0] += a * gx;
        hz[1] += a * gy;
        Hzz[0][0] += aw * gx * gx;
        Hzz[0][1] += aw * gx * gy;
        Hzz[1][1] += aw * gy * gy;
      }
      Hzz[1][0] = Hzz[0][1];
    }

    // rate rows g = +-(du - b dt): J over [u_prev (z), dt (z), u (v)]
    T gr[4];
    rate_g(uk, up, dt, gr);
    for (int idx = 0; idx < 4; ++idx) {
      const int comp = idx & 1;
      const T sgn = idx < 2 ? T(1) : T(-1);
      const T bnd = idx < 2 ? hi_r[comp] : lo_r[comp];
      const T t = mr[k * 4 + idx] + rho * gr[idx];
      const T a = hinge(t);
      const T aw = hinge_w(t, rho);
      const T jz_up = -sgn, jz_t = -sgn * bnd, jv = sgn;
      const int zi = 3 + comp;
      hz[zi] += a * jz_up;
      hu[comp] += a * jv;
      Hzz[zi][zi] += aw * jz_up * jz_up;
      Hzu[zi][comp] += aw * jz_up * jv;
      Huu[comp][comp] += aw * jv * jv;
      hz[5] += a * jz_t;
      Hzz[zi][5] += aw * jz_up * jz_t;
      Hzz[5][zi] = Hzz[zi][5];
      Hzz[5][5] += aw * jz_t * jz_t;
      Hzu[5][comp] += aw * jz_t * jv;
    }

    // box rows g = +-(u - b): J over u only
    T gb[4];
    box_g(uk, gb);
    for (int idx = 0; idx < 4; ++idx) {
      const int comp = idx & 1;
      const T sgn = idx < 2 ? T(1) : T(-1);
      const T t = mb[k * 4 + idx] + rho * gb[idx];
      hu[comp] += hinge(t) * sgn;
      Huu[comp][comp] += hinge_w(t, rho);
    }
  }

  // PN (6x6) and pN (6) of the terminal merit: the masked terminal equality,
  // the obstacle Gauss-Newton block at x_N (multiplier row N-1) and the dt box
  __device__ __forceinline__ void terminal_Pp(T P[NA][NA], T p[NA]) const {
    for (int i = 0; i < NA; ++i) {
      p[i] = T(0);
      for (int j = 0; j < NA; ++j) P[i][j] = T(0);
    }
    T xN[NX];
    x_at(N, xN);
    const T gd[NX] = {xN[0] - xf[0], xN[1] - xf[1], wrap(xN[2] - xf[2])};
    for (int i = 0; i < NX; ++i) {
      if (fixed[i]) {
        P[i][i] += rho;
        p[i] += lt[i] + rho * gd[i];
      }
    }
    const T* mu_row = mo + (N - 1) * M;
    for (int j = 0; j < M; ++j) {
      T gx, gy;
      const T g = obstacle_g(xN, j, gx, gy);
      const T t = mu_row[j] + rho * g;
      const T a = hinge(t);
      const T aw = t > T(0) ? rho : T(0);
      p[0] += a * gx;
      p[1] += a * gy;
      P[0][0] += aw * gx * gx;
      P[0][1] += aw * gx * gy;
      P[1][1] += aw * gy * gy;
    }
    P[1][0] = P[0][1];
    const T t1 = md[0] + rho * (dt - dt_max);
    const T t2 = md[1] + rho * (dt_min - dt);
    p[5] += hinge(t1) - hinge(t2);
    P[5][5] += hinge_w(t1, rho) + hinge_w(t2, rho);
  }

  // the Riccati sweep, the free dtau stage and the rollout: the step of one
  // SQP iteration into dxs, dus, dtau (the algebra of kernel K1)
  __device__ __forceinline__ void kkt_step(T reg) {
    T P[NA][NA], p[NA];
    terminal_Pp(P, p);
    for (int k = N - 1; k >= 0; --k) {
      T Fz[NA][NA], Gz[NA][NU], rz[NA];
      transition(k, Fz, Gz, rz);
      T hz[NA], hu[NU], Hzz[NA][NA], Hzu[NA][NU], Huu[NU][NU];
      stage_grad_hess(k, hz, hu, Hzz, Hzu, Huu);

      // PF = P Fz ; PG = P Gz ; Prp = P rz + p
      T PF[NA][NA], PG[NA][NU], Prp[NA];
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        T acc_r = T(0);
#pragma unroll
        for (int l = 0; l < NA; ++l) acc_r += P[i][l] * rz[l];
        Prp[i] = acc_r + p[i];
#pragma unroll
        for (int j = 0; j < NA; ++j) {
          T acc = T(0);
#pragma unroll
          for (int l = 0; l < NA; ++l) acc += P[i][l] * Fz[l][j];
          PF[i][j] = acc;
        }
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          T acc = T(0);
#pragma unroll
          for (int l = 0; l < NA; ++l) acc += P[i][l] * Gz[l][j];
          PG[i][j] = acc;
        }
      }
      // Qzz = Hzz + Fz' PF ; Qzu = Hzu + Fz' PG ; Quu = Huu + Gz' PG + reg I
      T Qzz[NA][NA], Qzu[NA][NU], Quu[NU][NU], qz[NA], qu[NU];
#pragma unroll
      for (int i = 0; i < NA; ++i) {
#pragma unroll
        for (int j = 0; j < NA; ++j) {
          T acc = T(0);
#pragma unroll
          for (int l = 0; l < NA; ++l) acc += Fz[l][i] * PF[l][j];
          Qzz[i][j] = Hzz[i][j] + acc;
        }
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          T acc = T(0);
#pragma unroll
          for (int l = 0; l < NA; ++l) acc += Fz[l][i] * PG[l][j];
          Qzu[i][j] = Hzu[i][j] + acc;
        }
        T acc = T(0);
#pragma unroll
        for (int l = 0; l < NA; ++l) acc += Fz[l][i] * Prp[l];
        qz[i] = hz[i] + acc;
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          T acc = T(0);
#pragma unroll
          for (int l = 0; l < NA; ++l) acc += Gz[l][i] * PG[l][j];
          Quu[i][j] = Huu[i][j] + acc + (i == j ? reg : T(0));
        }
        T acc = T(0);
#pragma unroll
        for (int l = 0; l < NA; ++l) acc += Gz[l][i] * Prp[l];
        qu[i] = hu[i] + acc;
      }
      // closed-form 2x2 inverse; K = -Quu^-1 Qzu' ; kff = -Quu^-1 qu
      const T inv_det = T(1) / (Quu[0][0] * Quu[1][1] - Quu[0][1] * Quu[1][0]);
      const T Qi[NU][NU] = {{Quu[1][1] * inv_det, -Quu[0][1] * inv_det},
                            {-Quu[1][0] * inv_det, Quu[0][0] * inv_det}};
      T Km[NU][NA], kf[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int j = 0; j < NA; ++j) Km[i][j] = -(Qi[i][0] * Qzu[j][0] + Qi[i][1] * Qzu[j][1]);
        kf[i] = -(Qi[i][0] * qu[0] + Qi[i][1] * qu[1]);
      }
      // P <- Qzz + Qzu K (symmetrized) ; p <- qz + Qzu kff
#pragma unroll
      for (int i = 0; i < NA; ++i) {
#pragma unroll
        for (int j = 0; j < NA; ++j) {
          const T v = Qzz[i][j] + (Qzu[i][0] * Km[0][j] + Qzu[i][1] * Km[1][j]);
          const T vT = Qzz[j][i] + (Qzu[j][0] * Km[0][i] + Qzu[j][1] * Km[1][i]);
          P[i][j] = T(0.5) * (v + vT);
        }
        p[i] = qz[i] + (Qzu[i][0] * kf[0] + Qzu[i][1] * kf[1]);
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        kft[k][i] = kf[i];
#pragma unroll
        for (int j = 0; j < NA; ++j) Kt[k][i][j] = Km[i][j];
      }
    }

    // free dtau: max(P_tau, tiny) that keeps a NaN (fmax would drop it)
    const T Ptau = P[NA - 1][NA - 1] + reg;
    const T den = Ptau < tiny<T>() ? tiny<T>() : Ptau;
    dtau = -p[NA - 1] / den;

    // forward rollout from z_0 = [0, 0, dtau]
    T z[NA];
    for (int i = 0; i < NA; ++i) z[i] = T(0);
    z[NA - 1] = dtau;
    for (int i = 0; i < NX; ++i) dxs[0][i] = T(0);
    for (int k = 0; k < N; ++k) {
      T Fz[NA][NA], Gz[NA][NU], rz[NA];
      transition(k, Fz, Gz, rz);
      T u[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < NA; ++j) acc += Kt[k][i][j] * z[j];
        u[i] = acc + kft[k][i];
      }
      T zn[NA];
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < NA; ++j) acc += Fz[i][j] * z[j];
        T accu = T(0);
#pragma unroll
        for (int l = 0; l < NU; ++l) accu += Gz[i][l] * u[l];
        zn[i] = acc + accu + rz[i];
      }
      for (int i = 0; i < NU; ++i) dus[k][i] = u[i];
      for (int i = 0; i < NX; ++i) dxs[k + 1][i] = zn[i];
      for (int i = 0; i < NA; ++i) z[i] = zn[i];
    }

    // NaN quarantine: a non-finite step becomes a zero step, whole
    bool ok = isfinite(dtau);
    for (int k = 0; k < N; ++k) {
      for (int i = 0; i < NX; ++i) ok = ok && isfinite(dxs[k + 1][i]);
      for (int i = 0; i < NU; ++i) ok = ok && isfinite(dus[k][i]);
    }
    if (!ok) {
      dtau = T(0);
      for (int k = 0; k <= N; ++k)
        for (int i = 0; i < NX; ++i) dxs[k][i] = T(0);
      for (int k = 0; k < N; ++k)
        for (int i = 0; i < NU; ++i) dus[k][i] = T(0);
    }
  }

  // the AL merit of the candidate (xs + al dxs [theta wrapped], us + al dus,
  // clip(dt + al dtau)), one pass over the stages
  __device__ __forceinline__ T merit(T al) const {
    const T dtv = clip(dt + al * dtau, dt_lo, dt_hi);
    T eq_lin = T(0), eq_sq = T(0), ineq = T(0);
    T xk[NX], uk[NU], up[NU];
    auto cand_x = [&](int k, T x[NX]) {
      x[0] = xs[k * NX + 0] + al * dxs[k][0];
      x[1] = xs[k * NX + 1] + al * dxs[k][1];
      x[2] = wrap(xs[k * NX + 2] + al * dxs[k][2]);
    };
    cand_x(0, xk);
    for (int i = 0; i < NU; ++i) up[i] = u_prev[i];
    for (int k = 0; k < N; ++k) {
      T xk1[NX], c[NX];
      cand_x(k + 1, xk1);
      for (int i = 0; i < NU; ++i) uk[i] = us[k * NU + i] + al * dus[k][i];
      defect_value(xk, uk, xk1, dtv, c);
      for (int i = 0; i < NX; ++i) {
        eq_lin += ld[k * NX + i] * c[i];
        eq_sq += c[i] * c[i];
      }
      // obstacle row k belongs to pose x_{k+1}
      for (int j = 0; j < M; ++j) {
        T gx, gy;
        const T mu = mo[k * M + j];
        const T a = hinge(mu + rho * obstacle_g(xk1, j, gx, gy));
        ineq += a * a - mu * mu;
      }
      T gr[4], gb[4];
      rate_g(uk, up, dtv, gr);
      box_g(uk, gb);
      for (int i = 0; i < 4; ++i) {
        const T mu_r = mr[k * 4 + i], mu_b = mb[k * 4 + i];
        const T ar = hinge(mu_r + rho * gr[i]), ab = hinge(mu_b + rho * gb[i]);
        ineq += (ar * ar - mu_r * mu_r) + (ab * ab - mu_b * mu_b);
      }
      for (int i = 0; i < NX; ++i) xk[i] = xk1[i];
      for (int i = 0; i < NU; ++i) up[i] = uk[i];
    }
    // terminal equality (xk holds the candidate x_N)
    const T gd[NX] = {xk[0] - xf[0], xk[1] - xf[1], wrap(xk[2] - xf[2])};
    for (int i = 0; i < NX; ++i) {
      if (fixed[i]) {
        eq_lin += lt[i] * gd[i];
        eq_sq += gd[i] * gd[i];
      }
    }
    // dt box, and the disabled terminal ball's constant row g = -BIG
    const T gdt[2] = {dtv - dt_max, dt_min - dtv};
    for (int i = 0; i < 2; ++i) {
      const T a = hinge(md[i] + rho * gdt[i]);
      ineq += a * a - md[i] * md[i];
    }
    const T ab = hinge(mball[0] - rho * T(BIG));
    ineq += ab * ab - mball[0] * mball[0];
    return T(N) * dtv + eq_lin + T(0.5) * rho * eq_sq + ineq / (T(2) * rho);
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS) k2a_kernel(const K2aArgs<T> a, const K2aParams prm) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int N = prm.N, M = prm.M;
  Lane<T> L;
  L.N = N;
  L.M = M;
  L.wb = T(prm.wheelbase);
  L.fp_r = T(prm.fp_radius);
  L.min_dist = T(prm.min_dist);
  L.dt_min = T(prm.dt_min);
  L.dt_max = T(prm.dt_max);
  L.dt_lo = T(prm.dt_lo);
  L.dt_hi = T(prm.dt_hi);
  for (int i = 0; i < NU; ++i) {
    L.lo_u[i] = T(prm.lo_u[i]);
    L.hi_u[i] = T(prm.hi_u[i]);
    L.lo_r[i] = T(prm.lo_r[i]);
    L.hi_r[i] = T(prm.hi_r[i]);
  }
  for (int i = 0; i < NX; ++i) L.fixed[i] = prm.xf_fixed[i] != 0;
  const size_t bb = static_cast<size_t>(b);
  L.xf = a.xf + bb * NX;
  L.u_prev = a.u_prev + bb * NU;
  L.oc = a.oc + bb * M * 2;
  L.orad = a.orad + bb * M;
  L.omask = a.omask + bb * M;
  L.xs = a.xs + bb * (N + 1) * NX;
  L.us = a.us + bb * N * NU;
  L.ld = a.ld + bb * N * NX;
  L.lt = a.lt + bb * NX;
  L.mo = a.mo + bb * N * M;
  L.mr = a.mr + bb * N * 4;
  L.mb = a.mb + bb * N * 4;
  L.md = a.md + bb * 2;
  L.mball = a.mball + bb;

  // ---- state init: the inputs become the working state ---------------- //
  for (int i = 0; i < (N + 1) * NX; ++i) L.xs[i] = a.xs_i[bb * (N + 1) * NX + i];
  for (int i = 0; i < N * NU; ++i) L.us[i] = a.us_i[bb * N * NU + i];
  for (int i = 0; i < N * NX; ++i) L.ld[i] = a.ld_i[bb * N * NX + i];
  for (int i = 0; i < N * M; ++i) L.mo[i] = a.mo_i[bb * N * M + i];
  for (int i = 0; i < N * 4; ++i) {
    L.mr[i] = a.mr_i[bb * N * 4 + i];
    L.mb[i] = a.mb_i[bb * N * 4 + i];
  }
  for (int i = 0; i < NX; ++i) L.lt[i] = a.lt_i[bb * NX + i];
  for (int i = 0; i < 2; ++i) L.md[i] = a.md_i[bb * 2 + i];
  L.mball[0] = a.mball_i[bb];
  L.dt = a.dt_i[b];
  L.rho = a.rho_i[b];

  const T inf = T(INFINITY);
  T viol_prev = inf, eq_last = inf, in_last = inf;
  T best_dt = L.dt, best_eq = inf, best_in = inf;
  bool found = false;
  const T reg0 = T(prm.reg0), tol_eq = T(prm.tol_eq), tol_ineq = T(prm.tol_ineq);

  for (int phase = 0; phase < prm.n_al; ++phase) {
    T reg = reg0;  // reg restarts each phase: the dual update reshapes the merit
    for (int it = 0; it < prm.n_sqp; ++it) {
      L.kkt_step(reg);

      // ---- line search: dt trust cap, candidates in order, alpha = 0 last
      const T adt = fabs(L.dtau);
      const T cap = adt > T(0)
                        ? vmin(T(prm.dt_trust_frac) * L.dt / vmax(adt, T(1e-30)), T(1))
                        : T(1);
      T best_m = inf, best_a = T(0);
      bool accepted = false;
      for (int c = 0; c < prm.n_alpha; ++c) {
        const T al = T(prm.alphas[c]) * cap;
        T m = L.merit(al);
        if (!isfinite(m)) m = inf;
        if (m < best_m) {
          best_m = m;
          best_a = al;
          accepted = al > T(0);
        }
      }
      T m0 = L.merit(T(0));
      m0 = isfinite(m0) ? vmin(m0, largest<T>()) : largest<T>();
      if (m0 < best_m) {
        best_a = T(0);
        accepted = false;
      }

      // ---- apply the winning candidate; reg shrinks or grows
      for (int k = 0; k <= N; ++k) {
        L.xs[k * NX + 0] += best_a * L.dxs[k][0];
        L.xs[k * NX + 1] += best_a * L.dxs[k][1];
        L.xs[k * NX + 2] = wrap(L.xs[k * NX + 2] + best_a * L.dxs[k][2]);
      }
      for (int k = 0; k < N; ++k)
        for (int i = 0; i < NU; ++i) L.us[k * NU + i] += best_a * L.dus[k][i];
      L.dt = clip(L.dt + best_a * L.dtau, L.dt_lo, L.dt_hi);
      reg = accepted ? vmax(reg * T(prm.reg_shrink), T(prm.reg_min))
                     : vmin(vmax(reg, reg0) * T(prm.reg_grow), T(prm.reg_max));
    }

    // ---- dual update with conditional rho growth ----------------------- //
    const T rho = L.rho;
    T eq_m = T(0), in_m = -inf;
    for (int k = 0; k < N; ++k) {
      T xk[NX], uk[NU], up[NU], xk1[NX], c[NX];
      L.x_at(k, xk);
      L.u_at(k, uk);
      L.uprev_at(k, up);
      L.x_at(k + 1, xk1);
      L.defect_value(xk, uk, xk1, L.dt, c);
      for (int i = 0; i < NX; ++i) {
        L.ld[k * NX + i] += rho * c[i];
        eq_m = vmax(eq_m, T(fabs(c[i])));
      }
      for (int j = 0; j < M; ++j) {
        T gx, gy;
        const T g = L.obstacle_g(xk1, j, gx, gy);
        L.mo[k * M + j] = hinge(L.mo[k * M + j] + rho * g);
        in_m = vmax(in_m, g);
      }
      T gr[4], gb[4];
      L.rate_g(uk, up, L.dt, gr);
      L.box_g(uk, gb);
      for (int i = 0; i < 4; ++i) {
        L.mr[k * 4 + i] = hinge(L.mr[k * 4 + i] + rho * gr[i]);
        L.mb[k * 4 + i] = hinge(L.mb[k * 4 + i] + rho * gb[i]);
        in_m = vmax(in_m, vmax(gr[i], gb[i]));
      }
    }
    T xN[NX];
    L.x_at(N, xN);
    const T gd[NX] = {xN[0] - L.xf[0], xN[1] - L.xf[1], wrap(xN[2] - L.xf[2])};
    for (int i = 0; i < NX; ++i) {
      if (L.fixed[i]) {
        L.lt[i] += rho * gd[i];
        eq_m = vmax(eq_m, T(fabs(gd[i])));
      } else {
        L.lt[i] = T(0);
      }
    }
    const T gdt[2] = {L.dt - L.dt_max, L.dt_min - L.dt};
    for (int i = 0; i < 2; ++i) {
      L.md[i] = hinge(L.md[i] + rho * gdt[i]);
      in_m = vmax(in_m, gdt[i]);
    }
    // the disabled terminal ball's row g = -BIG clamps its multiplier to 0
    L.mball[0] = hinge(L.mball[0] - rho * T(BIG));
    in_m = vmax(in_m, T(-BIG));
    in_m = hinge(in_m);
    const T viol = vmax(eq_m, in_m);
    const bool grow = viol > T(prm.viol_decrease_req) * viol_prev || viol > T(0.05) * tol_eq;
    L.rho = grow ? vmin(rho * T(prm.rho_growth), T(prm.rho_max)) : rho;
    viol_prev = viol;
    eq_last = eq_m;
    in_last = in_m;

    // ---- best-feasible snapshot ---------------------------------------- //
    if (eq_m < tol_eq && in_m < tol_ineq) {
      for (int k = 0; k <= N; ++k)
        for (int i = 0; i < NX; ++i) L.bxs[k][i] = L.xs[k * NX + i];
      for (int k = 0; k < N; ++k)
        for (int i = 0; i < NU; ++i) L.bus[k][i] = L.us[k * NU + i];
      best_dt = L.dt;
      best_eq = eq_m;
      best_in = in_m;
      found = true;
    }
  }

  // ---- final selection (select, not blend) and outputs ------------------ //
  const bool final_ok = eq_last < tol_eq && in_last < tol_ineq;
  const bool use_best = found && !final_ok;
  if (use_best) {
    for (int k = 0; k <= N; ++k)
      for (int i = 0; i < NX; ++i) L.xs[k * NX + i] = L.bxs[k][i];
    for (int k = 0; k < N; ++k)
      for (int i = 0; i < NU; ++i) L.us[k * NU + i] = L.bus[k][i];
  }
  const T dt_fin = use_best ? best_dt : L.dt;
  a.dt[b] = dt_fin;
  a.rho[b] = L.rho;
  a.cost[b] = T(N) * dt_fin;
  a.eq[b] = use_best ? best_eq : eq_last;
  a.ineq[b] = use_best ? best_in : in_last;
  a.conv[b] = (final_ok || found) ? 1 : 0;
}

template <typename T>
int launch(const K2aParams* prm, const void* const* in, void* const* out, int B, void* stream) {
  if (B <= 0 || prm->N <= 0 || prm->N > MAX_N || prm->M < 0 || prm->M > MAX_M ||
      prm->n_alpha <= 0 || prm->n_alpha > MAX_ALPHAS || prm->n_al <= 0 || prm->n_sqp <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  K2aArgs<T> a;
  a.xs_i = static_cast<const T*>(in[0]);
  a.us_i = static_cast<const T*>(in[1]);
  a.dt_i = static_cast<const T*>(in[2]);
  a.xf = static_cast<const T*>(in[3]);
  a.u_prev = static_cast<const T*>(in[4]);
  a.oc = static_cast<const T*>(in[5]);
  a.orad = static_cast<const T*>(in[6]);
  a.omask = static_cast<const unsigned char*>(in[7]);
  a.ld_i = static_cast<const T*>(in[8]);
  a.lt_i = static_cast<const T*>(in[9]);
  a.mo_i = static_cast<const T*>(in[10]);
  a.mr_i = static_cast<const T*>(in[11]);
  a.mb_i = static_cast<const T*>(in[12]);
  a.md_i = static_cast<const T*>(in[13]);
  a.mball_i = static_cast<const T*>(in[14]);
  a.rho_i = static_cast<const T*>(in[15]);
  a.xs = static_cast<T*>(out[0]);
  a.us = static_cast<T*>(out[1]);
  a.dt = static_cast<T*>(out[2]);
  a.ld = static_cast<T*>(out[3]);
  a.lt = static_cast<T*>(out[4]);
  a.mo = static_cast<T*>(out[5]);
  a.mr = static_cast<T*>(out[6]);
  a.mb = static_cast<T*>(out[7]);
  a.md = static_cast<T*>(out[8]);
  a.mball = static_cast<T*>(out[9]);
  a.rho = static_cast<T*>(out[10]);
  a.cost = static_cast<T*>(out[11]);
  a.eq = static_cast<T*>(out[12]);
  a.ineq = static_cast<T*>(out[13]);
  a.conv = static_cast<unsigned char*>(out[14]);
  a.B = B;
  const int blocks = (B + THREADS - 1) / THREADS;
  k2a_kernel<T><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a, *prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int k2a_max_n() { return MAX_N; }
int k2a_max_m() { return MAX_M; }
int k2a_max_alphas() { return MAX_ALPHAS; }
int k2a_params_size() { return static_cast<int>(sizeof(K2aParams)); }

// in: xs, us, dt, xf, u_prev, circle centers, radii, mask, lam_def,
//     lam_term, mu_obs, mu_rate, mu_box, mu_dt, mu_ball, rho (16 pointers)
// out: xs, us, dt, lam_def, lam_term, mu_obs, mu_rate, mu_box, mu_dt,
//      mu_ball, rho, cost, eq_norm, ineq_viol, converged (15 pointers)
int k2a_fused_solve_f32(const K2aParams* prm, const void* const* in, void* const* out, int B,
                        void* stream) {
  return launch<float>(prm, in, out, B, stream);
}

int k2a_fused_solve_f64(const K2aParams* prm, const void* const* in, void* const* out, int B,
                        void* stream) {
  return launch<double>(prm, in, out, B, stream);
}

const char* k2a_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
