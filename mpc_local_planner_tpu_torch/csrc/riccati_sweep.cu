// Kernel K1: the batched Riccati sweep, the KKT solve of every SQP iteration.
//
// Replaces the TPU kernel mpc_local_planner_tpu/ops/riccati_pallas.py ::
// _riccati_kernel and computes exactly what it computes, per scenario:
//   1. the backward sweep over the augmented z = [dx(3), du_prev(2), dtau]
//      (NA = 6, NU = 2), building Qzz, Qzu and Quu with reg on Quu's diagonal;
//   2. the closed-form 2x2 Quu inverse;
//   3. the symmetrized P update and the K/kff gain tape;
//   4. the dV accumulation;
//   5. the free-dtau initial stage (floored at the working type's tiny);
//   6. the forward rollout.
//
// Bound on an H100: memory. Per scenario the sweep reads 114 values per
// stage (Fz 36, Gz 12, rz 6, Hzz 36, Hzu 12, Huu 4, hz 6, hu 2) plus PN, pN
// and reg once, and writes (N+1)*3 + N*2 + 2 values: at N = 30 in float that
// is 13,852 B in and 620 B out, 59.3 MB for a batch of 4096, about 18 us at
// 3.35 TB/s. The arithmetic (~10 kFLOP per scenario) is negligible.
//
// Design: one thread per scenario, the simplest layout that is right. P and
// p live in registers, the K/kff tape (N*14 values) in local memory, which
// the hardware interleaves across threads. Inputs keep the B,N,... layout
// of the wrapper's tensors, so neighbouring threads read 13.8 KB apart and
// the loads are not coalesced: the kernel is far from its bound, and a
// stage-major or warp-cooperative layout is the next design. The kernel is
// templated on float and double so that the card can check the algorithm in
// f64, free of f32 noise.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream and returns cudaGetLastError() (0 on success).

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int NA = 6;
constexpr int NU = 2;
constexpr int NX = 3;
constexpr int MAX_N = 64;
constexpr int THREADS = 128;

template <typename T> __device__ __forceinline__ T tiny();
template <> __device__ __forceinline__ float tiny<float>() { return FLT_MIN; }
template <> __device__ __forceinline__ double tiny<double>() { return DBL_MIN; }

template <typename T>
__global__ void __launch_bounds__(THREADS) riccati_sweep_kernel(
    const T* __restrict__ Fz, const T* __restrict__ Gz, const T* __restrict__ rz,
    const T* __restrict__ Hzz, const T* __restrict__ Hzu, const T* __restrict__ Huu,
    const T* __restrict__ hz, const T* __restrict__ hu, const T* __restrict__ PN,
    const T* __restrict__ pN, const T* __restrict__ reg,
    T* __restrict__ dxs, T* __restrict__ dus, T* __restrict__ dtau_o,
    T* __restrict__ dv_o, int B, int N, int free_tau) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t bN = static_cast<size_t>(b) * N;
  const T* F_b = Fz + bN * NA * NA;
  const T* G_b = Gz + bN * NA * NU;
  const T* r_b = rz + bN * NA;
  const T* Hzz_b = Hzz + bN * NA * NA;
  const T* Hzu_b = Hzu + bN * NA * NU;
  const T* Huu_b = Huu + bN * NU * NU;
  const T* hz_b = hz + bN * NA;
  const T* hu_b = hu + bN * NU;

  T P[NA][NA], p[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    p[i] = pN[static_cast<size_t>(b) * NA + i];
#pragma unroll
    for (int j = 0; j < NA; ++j) P[i][j] = PN[static_cast<size_t>(b) * NA * NA + i * NA + j];
  }
  const T regv = reg[b];
  T K_tape[MAX_N][NU][NA];
  T kff_tape[MAX_N][NU];
  T dv = T(0);

  // ---- backward sweep ------------------------------------------------ //
  for (int k = N - 1; k >= 0; --k) {
    const T* F = F_b + static_cast<size_t>(k) * NA * NA;
    const T* G = G_b + static_cast<size_t>(k) * NA * NU;
    const T* r = r_b + static_cast<size_t>(k) * NA;

    // PF = P F ; PG = P G ; Prp = P r + p
    T PF[NA][NA], PG[NA][NU], Prp[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      T acc_r = T(0);
#pragma unroll
      for (int l = 0; l < NA; ++l) acc_r += P[i][l] * r[l];
      Prp[i] = acc_r + p[i];
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        T acc = T(0);
#pragma unroll
        for (int l = 0; l < NA; ++l) acc += P[i][l] * F[l * NA + j];
        PF[i][j] = acc;
      }
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        T acc = T(0);
#pragma unroll
        for (int l = 0; l < NA; ++l) acc += P[i][l] * G[l * NU + j];
        PG[i][j] = acc;
      }
    }

    // Qzz = Hzz + F' PF ; Qzu = Hzu + F' PG ; Quu = Huu + G' PG + reg I
    T Qzz[NA][NA], Qzu[NA][NU], Quu[NU][NU], qz[NA], qu[NU];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        T acc = T(0);
#pragma unroll
        for (int l = 0; l < NA; ++l) acc += F[l * NA + i] * PF[l][j];
        Qzz[i][j] = Hzz_b[static_cast<size_t>(k) * NA * NA + i * NA + j] + acc;
      }
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        T acc = T(0);
#pragma unroll
        for (int l = 0; l < NA; ++l) acc += F[l * NA + i] * PG[l][j];
        Qzu[i][j] = Hzu_b[static_cast<size_t>(k) * NA * NU + i * NU + j] + acc;
      }
      T acc = T(0);
#pragma unroll
      for (int l = 0; l < NA; ++l) acc += F[l * NA + i] * Prp[l];
      qz[i] = hz_b[static_cast<size_t>(k) * NA + i] + acc;
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        T acc = T(0);
#pragma unroll
        for (int l = 0; l < NA; ++l) acc += G[l * NU + i] * PG[l][j];
        Quu[i][j] = Huu_b[static_cast<size_t>(k) * NU * NU + i * NU + j] + acc +
                    (i == j ? regv : T(0));
      }
      T acc = T(0);
#pragma unroll
      for (int l = 0; l < NA; ++l) acc += G[l * NU + i] * Prp[l];
      qu[i] = hu_b[static_cast<size_t>(k) * NU + i] + acc;
    }

    // closed-form 2x2 inverse of Quu
    const T inv_det = T(1) / (Quu[0][0] * Quu[1][1] - Quu[0][1] * Quu[1][0]);
    const T Qi[NU][NU] = {{Quu[1][1] * inv_det, -Quu[0][1] * inv_det},
                          {-Quu[1][0] * inv_det, Quu[0][0] * inv_det}};
    // K = -Quu^-1 Qzu' ; kff = -Quu^-1 qu
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
      kff_tape[k][i] = kf[i];
#pragma unroll
      for (int j = 0; j < NA; ++j) K_tape[k][i][j] = Km[i][j];
    }
    dv -= T(0.5) * (qu[0] * kf[0] + qu[1] * kf[1]);
  }

  // ---- initial stage: free dtau minimization -------------------------- //
  const T Ptau = P[NA - 1][NA - 1] + regv;
  // max(Ptau, tiny) that keeps a NaN (fmax would drop it)
  const T den = Ptau < tiny<T>() ? tiny<T>() : Ptau;
  const T dtau = free_tau ? -p[NA - 1] / den : T(0);
  const T dv_tau = free_tau ? T(0.5) * Ptau * dtau * dtau : T(0);
  dtau_o[b] = dtau;
  dv_o[b] = dv + dv_tau;

  // ---- forward rollout ------------------------------------------------ //
  T* dxs_b = dxs + static_cast<size_t>(b) * (N + 1) * NX;
  T* dus_b = dus + bN * NU;
  T z[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) z[i] = T(0);
  z[NA - 1] = dtau;
#pragma unroll
  for (int i = 0; i < NX; ++i) dxs_b[i] = T(0);
  for (int k = 0; k < N; ++k) {
    const T* F = F_b + static_cast<size_t>(k) * NA * NA;
    const T* G = G_b + static_cast<size_t>(k) * NA * NU;
    const T* r = r_b + static_cast<size_t>(k) * NA;
    T u[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < NA; ++j) acc += K_tape[k][i][j] * z[j];
      u[i] = acc + kff_tape[k][i];
    }
    T zn[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < NA; ++j) acc += F[i * NA + j] * z[j];
      T accu = T(0);
#pragma unroll
      for (int l = 0; l < NU; ++l) accu += G[i * NU + l] * u[l];
      zn[i] = acc + accu + r[i];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) dus_b[static_cast<size_t>(k) * NU + i] = u[i];
#pragma unroll
    for (int i = 0; i < NX; ++i) dxs_b[static_cast<size_t>(k + 1) * NX + i] = zn[i];
#pragma unroll
    for (int i = 0; i < NA; ++i) z[i] = zn[i];
  }
}

template <typename T>
int launch(const T* Fz, const T* Gz, const T* rz, const T* Hzz, const T* Hzu,
           const T* Huu, const T* hz, const T* hu, const T* PN, const T* pN,
           const T* reg, T* dxs, T* dus, T* dtau, T* dv, int B, int N,
           int free_tau, void* stream) {
  if (B <= 0 || N <= 0 || N > MAX_N) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + THREADS - 1) / THREADS;
  riccati_sweep_kernel<T><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      Fz, Gz, rz, Hzz, Hzu, Huu, hz, hu, PN, pN, reg, dxs, dus, dtau, dv, B, N,
      free_tau);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int riccati_sweep_max_n() { return MAX_N; }

int riccati_sweep_f32(const float* Fz, const float* Gz, const float* rz,
                      const float* Hzz, const float* Hzu, const float* Huu,
                      const float* hz, const float* hu, const float* PN,
                      const float* pN, const float* reg, float* dxs, float* dus,
                      float* dtau, float* dv, int B, int N, int free_tau,
                      void* stream) {
  return launch<float>(Fz, Gz, rz, Hzz, Hzu, Huu, hz, hu, PN, pN, reg, dxs, dus,
                       dtau, dv, B, N, free_tau, stream);
}

int riccati_sweep_f64(const double* Fz, const double* Gz, const double* rz,
                      const double* Hzz, const double* Hzu, const double* Huu,
                      const double* hz, const double* hu, const double* PN,
                      const double* pN, const double* reg, double* dxs,
                      double* dus, double* dtau, double* dv, int B, int N,
                      int free_tau, void* stream) {
  return launch<double>(Fz, Gz, rz, Hzz, Hzu, Huu, hz, hu, PN, pN, reg, dxs, dus,
                        dtau, dv, B, N, free_tau, stream);
}

const char* riccati_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
