// E1 fused_xpass with double factors (every X type, both layouts, bf16
// off and on): the instantiations that epi.cu declares extern, compiled
// here beside it so that the two halves of E1 build at once.

#include "epi_xpass.cuh"

namespace ccfindr {

E1_EXTERN(, double)

}  // namespace ccfindr
