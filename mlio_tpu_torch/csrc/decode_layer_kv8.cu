// K4's instances over an INT8 cache (decode_layer.cu has the kernel's note
// and the bf16 cache's instances): one source a cache type, so that the two
// build in parallel.
#define MLIO_STACK_KV8 true
#include "decode_layer.cu"
