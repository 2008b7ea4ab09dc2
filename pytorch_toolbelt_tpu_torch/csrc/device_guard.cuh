// Scoped device switch for the C entry points.
//
// Each entry point runs its launches on the device of the tensors it was
// given, then leaves the calling thread on the device it was on before, as
// PyTorch's own operators do: a launch on a cuda:1 tensor from a thread whose
// current device is cuda:0 leaves that thread on cuda:0.
#pragma once

#include <cuda_runtime.h>

namespace ptt {

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&previous_);
    if (err_ == cudaSuccess && previous_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(previous_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  // cudaSuccess, or why the device could not be read or set
  cudaError_t error() const { return err_; }

 private:
  int previous_ = -1;
  bool switched_ = false;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace ptt
