// K6, the tiled decode megakernel, with bf16 weights: the kernel, its bound
// and its design are in decode_tiled.cuh.
#define MLIO_TILED_FMT 0
#include "decode_tiled.cuh"
