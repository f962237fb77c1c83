// sample_variants.cuh in float32: one library of the probe library's sampler
// variants (see sample_variants.cuh).

#define VARIANT_BF 0
#include "sample_variants.cuh"
