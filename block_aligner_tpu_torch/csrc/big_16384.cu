// The 16384-row instances of csrc/big_kernel.cu, one library of their own:
// max_size 16384 (percent_len's clamp), whose checkpoint planes live in a
// per-pair scratch in global memory, with ByteMatrix scoring and the
// local-start, free-query-start-gap and free-query-end-gap flags read from
// big_align_launch's `flags`.
#define BIG_FLAGS true
#define BIG_16384 true
#include "big_kernel.cu"
