// The recon kernels' instances with sign-data hiding or dependent
// quantization (csrc/recon_intra.cu, kQSdh and kQDq), compiled apart from
// the element-wise ones so that those compile as they did without them
// and both halves build at once; csrc/recon_intra.cu's entry points reach
// them through x266_recon_quant.
#define X266_RECON_QUANT_PART
#include "recon_intra.cu"
