// sample_variants.cuh in bfloat16: one library of the probe library's sampler
// variants (see sample_variants.cuh).

#define VARIANT_BF 1
#include "sample_variants.cuh"
