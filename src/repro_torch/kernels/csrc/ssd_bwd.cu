// The backward instantiations of the Mamba2 SSD's kernels (ssd.cuh), a
// translation unit of their own so that nvcc builds them in parallel with
// the forward's (ssd.cu).
#include "ssd.cuh"

namespace ssd_cuda {

template int bwd<64, 64>(const Args&, cudaStream_t);
template int bwd<256, 128>(const Args&, cudaStream_t);

}  // namespace ssd_cuda
