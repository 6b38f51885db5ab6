// K6, the tiled decode megakernel, with fp8 weights: the kernel, its bound
// and its design are in decode_tiled.cuh.
#define MLIO_TILED_FMT 2
#include "decode_tiled.cuh"
