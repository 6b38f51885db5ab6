// K6, the tiled decode megakernel, with int8 weights: the kernel, its bound
// and its design are in decode_tiled.cuh.
#define MLIO_TILED_FMT 1
#include "decode_tiled.cuh"
