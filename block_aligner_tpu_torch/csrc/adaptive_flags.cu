// The FLAGS instances of csrc/adaptive_kernel.cu, one library of their
// own: ByteMatrix scoring and the local-start, free-query-start-gap and
// free-query-end-gap flags, read from adaptive_align_launch's `flags`.
#define ADAPTIVE_FLAGS true
#include "adaptive_kernel.cu"
