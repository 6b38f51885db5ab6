// K6, the tiled decode megakernel, at head dim 256 (Gemma): bf16 weights and
// cache, 1-4 query heads a KV head. A source of its own so that the instance
// builds beside the other formats' and lengthens none of them; the kernel,
// its bound and its design are in decode_tiled.cuh.
#define MLIO_TILED_FMT 0
#define MLIO_TILED_D256
#include "decode_tiled.cuh"
