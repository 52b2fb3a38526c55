// The CUDA runtime's message for an error code that a launch entry point of
// the kernel library returned; shared by every kernel source, loaded with
// ctypes by mmtpu_torch/kernels/build.py.

#include <cuda_runtime.h>

extern "C" const char* cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
