// The traced 16384-row instances of csrc/big_kernel.cu, one library of
// their own: csrc/big_16384.cu with trace (csrc/big_trace.cu), whose row
// words accumulate in place in the pair's trace buffer.
#define BIG_TRACE true
#define BIG_FLAGS true
#define BIG_16384 true
#include "big_kernel.cu"
