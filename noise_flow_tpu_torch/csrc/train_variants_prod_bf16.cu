// train_variants.cuh in the production design, bfloat16: one library of the probe
// library's template variants (see train_variants.cuh).

#define VARIANT_DESIGN DESIGN_PROD
#define VARIANT_BF true
#include "train_variants.cuh"
