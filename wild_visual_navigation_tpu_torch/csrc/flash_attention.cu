// K1's host entry and its head dim 64 (the ViTs' and the main path's).
// The kernels, their design and what bounds them: flash_attention.cuh.
// Head dims 32, 128 and 256 are compiled in flash_attention_d{32,128,256}.cu.
#include "flash_attention.cuh"

WVN_K1_DEFINE_D(64)
WVN_K1_DECLARE_D(32)
WVN_K1_DECLARE_D(128)
WVN_K1_DECLARE_D(256)

// q, k, v, o: (B, H, S, D) with a contiguous D axis, D in {32, 64, 128, 256}
// (the wrapper pads any other D <= 256); strides points to 12 int64 on the
// host, the (B, H, S) strides in elements of q, k, v and o. dtype 0 =
// float32 (block_q = block_k = 0: its own tile), 1 = bfloat16 with the tile
// (block_q, block_k) (0 for either: 64). bf16 needs 16-byte aligned bases
// and strides (the wrapper checks). A tile or head dim the library does not
// hold returns cudaErrorInvalidValue and launches nothing.
extern "C" int wvn_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, const void* strides,
                                       int B, int H, int S, int D, int dtype, float scale, int block_q, int block_k,
                                       void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  K1Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  const long long* sp = static_cast<const long long*>(strides);
  for (int i = 0; i < 12; ++i) a.st[i] = sp[i];
  a.B = B;
  a.H = H;
  a.S = S;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    block_q = block_q ? block_q : 64;
    block_k = block_k ? block_k : 64;
  }
  switch (D) {
    case 32: return wvn_k1_d32(a, dtype, block_q, block_k);
    case 64: return wvn_k1_d64(a, dtype, block_q, block_k);
    case 128: return wvn_k1_d128(a, dtype, block_q, block_k);
    case 256: return wvn_k1_d256(a, dtype, block_q, block_k);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of a launch at (D, dtype, block_q, block_k), in
// bytes; -1 where the library holds no such kernel.
extern "C" int wvn_flash_attention_smem_bytes(int D, int dtype, int block_q, int block_k) {
  if (dtype == 1) {
    block_q = block_q ? block_q : 64;
    block_k = block_k ? block_k : 64;
  }
  switch (D) {
    case 32: return wvn_k1_smem_d32(dtype, block_q, block_k);
    case 64: return wvn_k1_smem_d64(dtype, block_q, block_k);
    case 128: return wvn_k1_smem_d128(dtype, block_q, block_k);
    case 256: return wvn_k1_smem_d256(dtype, block_q, block_k);
    default: return -1;
  }
}

extern "C" const char* wvn_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
