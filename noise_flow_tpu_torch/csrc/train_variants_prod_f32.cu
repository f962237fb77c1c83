// train_variants.cuh in the production design, float32: one library of the probe
// library's template variants (see train_variants.cuh).

#define VARIANT_DESIGN DESIGN_PROD
#define VARIANT_BF false
#include "train_variants.cuh"
