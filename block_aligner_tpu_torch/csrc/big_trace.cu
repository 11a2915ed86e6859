// The trace instances of csrc/big_kernel.cu, one library of their own: the
// traceback words of every step in a layout sized by the block that ran,
// and its descriptors.
#define BIG_TRACE true
#include "big_kernel.cu"
