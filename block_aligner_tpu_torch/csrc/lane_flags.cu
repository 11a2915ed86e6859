// The FLAGS instances of csrc/lane_kernel.cu, one library of their own:
// ByteMatrix scoring and the local-start, free-query-start-gap and
// free-query-end-gap flags, read from lane_align_launch's `flags`.
#define LANE_FLAGS true
#include "lane_kernel.cu"
