// Entry points of the Mamba2 SSD's chunked-scan kernels (B14): the
// kernels and their design are in ssd.cuh.
#include <type_traits>

#include "ssd.cuh"

namespace ssd_cuda {

// The (L, N) pairs the kernels are built for: zamba2-2.7b's (64, 64) and
// granite-4.0-h-small's (256, 128).  The forward's are compiled here, the
// backward's in ssd_bwd.cu, which nvcc builds in parallel with this file.
template int fwd<64, 64>(const Args&, cudaStream_t);
template int fwd<256, 128>(const Args&, cudaStream_t);
extern template int bwd<64, 64>(const Args&, cudaStream_t);
extern template int bwd<256, 128>(const Args&, cudaStream_t);

bool valid(int b, int s, int H, int L, int N) {
  if (b <= 0 || s <= 0 || H <= 0 || !((L == 64 && N == 64) ||
      (L == 256 && N == 128)) || s % L != 0) {
    return false;
  }
  const long long bc = (long long)b * (s / L);
  return bc <= 65535 && H <= 65535 && (long long)b * H <= 65535;
}

template <class F>
int dispatch(int L, F&& f) {
  if (L == 64) return f(std::integral_constant<int, 64>(),
                        std::integral_constant<int, 64>());
  return f(std::integral_constant<int, 256>(),
           std::integral_constant<int, 128>());
}

}  // namespace ssd_cuda

using ssd_cuda::Args;
using ssd_cuda::bf16;

// x (b, s, h, 64), B and C (b, s, n) bf16; dt, la (b, s, h) and h0 (b, h,
// 64, n) f32, contiguous; (L, n) (64, 64) or (256, 128), L dividing s.
// Writes y (b, s, h, 64), h_final (h0's shape), states (b, s / L, h, 64,
// n): the state before each chunk, and Acs (b, s / L, h, L), f32.
extern "C" int ssd_fwd_launch(const void* x, const float* dt,
                              const float* la, const void* B, const void* C,
                              const float* h0, float* y, float* hT,
                              float* states, float* Acs, int b, int s, int H,
                              int L, int N, void* stream) {
  if (!ssd_cuda::valid(b, s, H, L, N)) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.x = static_cast<const bf16*>(x);
  a.dt = dt;
  a.la = la;
  a.B = static_cast<const bf16*>(B);
  a.C = static_cast<const bf16*>(C);
  a.h0 = h0;
  a.y = y;
  a.hT = hT;
  a.states = states;
  a.Acs = Acs;
  a.b = b;
  a.s = s;
  a.H = H;
  a.nc = s / L;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ssd_cuda::dispatch(L, [&](auto l, auto n) {
    return ssd_cuda::fwd<decltype(l)::value, decltype(n)::value>(a, st);
  });
}

// The backward of ssd_fwd_launch for dy (y's shape) and dhT (h_final's,
// or null), with x, dt, B, C, states and Acs as the forward had them.
// Writes each of dx, dB, dC (bf16), ddt, dla, dh0 (f32) that is not null;
// V, dAq, dTs, dCB, dA, dT are scratch of the sizes ssd.py gives.
extern "C" int ssd_bwd_launch(const void* x, const float* dt, const void* B,
                              const void* C, const float* states,
                              const float* Acs, const float* dy,
                              const float* dhT, void* dx, float* ddt,
                              float* dla, void* dB, void* dC, float* dh0,
                              float* V, float* dAq, float* dTs, float* dCB,
                              float* dA, float* dT, int b, int s, int H,
                              int L, int N, void* stream) {
  if (!ssd_cuda::valid(b, s, H, L, N)) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.x = static_cast<const bf16*>(x);
  a.dt = dt;
  a.B = static_cast<const bf16*>(B);
  a.C = static_cast<const bf16*>(C);
  a.states = const_cast<float*>(states);
  a.Acs = const_cast<float*>(Acs);
  a.dy = dy;
  a.dhT = dhT;
  a.dx = static_cast<bf16*>(dx);
  a.ddt = ddt;
  a.dla = dla;
  a.dB = static_cast<bf16*>(dB);
  a.dC = static_cast<bf16*>(dC);
  a.dh0 = dh0;
  a.V = V;
  a.dAq = dAq;
  a.dTs = dTs;
  a.dCB = dCB;
  a.dA = dA;
  a.dT = dT;
  a.b = b;
  a.s = s;
  a.H = H;
  a.nc = s / L;
  a.groups = (H + ssd_cuda::kGroup - 1) / ssd_cuda::kGroup;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ssd_cuda::dispatch(L, [&](auto l, auto n) {
    return ssd_cuda::bwd<decltype(l)::value, decltype(n)::value>(a, st);
  });
}
