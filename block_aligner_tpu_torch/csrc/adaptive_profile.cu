// The profile instances of csrc/adaptive_kernel.cu (sequence-to-PSSM
// alignment), one library of their own: its adaptive_align_launch reads the
// queries' codes and the profiles' packed words (ops/_profile.py).
#define ADAPTIVE_PROFILE true
#include "adaptive_kernel.cu"
