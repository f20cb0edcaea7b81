// K1 at head dim 256: the kernels of flash_attention.cuh, compiled apart so the
// build runs this unit beside the others.
#include "flash_attention.cuh"

WVN_K1_DEFINE_D(256)
