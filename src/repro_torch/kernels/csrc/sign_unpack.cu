// 1-bit sign unpacking for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sign_pack.py::sign_unpack_3d
// (_unpack_kernel): the inverse of sign_pack, bit -> 2*bit - 1 as f32 (+1.0
// or -1.0), in the lane-interleaved layout (element e is bit (e / 128) % 8 of
// byte (e / 1024) * 128 + e % 128).  Only the first n floats are written,
// which is what the reference keeps after its [:n].
//
// Bound: bytes.  It reads 1/8 B and writes 4 B per element: 4.125 B/element.
// Design: one thread per 4 packed bytes (lanes l..l+3 of one byte row), read
// as one 32-bit load; for k = 0..7 it writes the float4 at
// out[r*1024 + k*128 + l], so a warp writes 512 contiguous bytes per k.  A
// masked scalar path covers the ragged tail and unaligned pointers; offsets
// are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float bit_sign(unsigned int word, int shift) {
  return ((word >> shift) & 1u) ? 1.0f : -1.0f;
}

__global__ void sign_unpack_kernel(const unsigned char* __restrict__ packed,
                                   float* __restrict__ out, long long n, int vec_in,
                                   int vec_out) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long b = q * 4;
  const long long base = (b >> 7) * 1024 + (b & 127);  // element of bit 0, lane l
  if (base >= n) return;
  const unsigned int word =
      vec_in ? *reinterpret_cast<const unsigned int*>(packed + b)
             : (static_cast<unsigned int>(packed[b]) |
                (static_cast<unsigned int>(packed[b + 1]) << 8) |
                (static_cast<unsigned int>(packed[b + 2]) << 16) |
                (static_cast<unsigned int>(packed[b + 3]) << 24));
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const long long e = base + k * 128;
    const float4 v = make_float4(bit_sign(word, k), bit_sign(word, 8 + k),
                                 bit_sign(word, 16 + k), bit_sign(word, 24 + k));
    if (vec_out && e + 4 <= n) {
      *reinterpret_cast<float4*>(out + e) = v;
    } else {
      if (e < n) out[e] = v.x;
      if (e + 1 < n) out[e + 1] = v.y;
      if (e + 2 < n) out[e + 2] = v.z;
      if (e + 3 < n) out[e + 3] = v.w;
    }
  }
}

}  // namespace

// packed must hold ceil(n / 1024) * 128 bytes (the wrapper checks it).
extern "C" int sign_unpack_launch(const unsigned char* packed, float* out, long long n,
                                  cudaStream_t stream) {
  if (n <= 0) return 0;
  const int vec_in = reinterpret_cast<uintptr_t>(packed) % 4 == 0;
  const int vec_out = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int threads = 256;
  const long long quads = (n + 1023) / 1024 * 32;  // 4-byte groups of the byte rows in use
  const unsigned int blocks = static_cast<unsigned int>((quads + threads - 1) / threads);
  sign_unpack_kernel<<<blocks, threads, 0, stream>>>(packed, out, n, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}
