// The traced FLAGS instances of csrc/big_kernel.cu, one library of their
// own: trace (csrc/big_trace.cu) with ByteMatrix scoring and the
// local-start, free-query-start-gap and free-query-end-gap flags, read from
// big_align_launch's `flags`.
#define BIG_TRACE true
#define BIG_FLAGS true
#include "big_kernel.cu"
