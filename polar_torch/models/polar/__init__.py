from polar_torch.models.polar.construction import (
    gen_arikan,
    generate_5g_ranking,
    generate_ga_code,
    generate_rm_code,
    get_kern_frozen_bits,
    get_ref_rm_frozen_bits,
)
from polar_torch.models.polar.kernels import KERNELS, get_kernel
from polar_torch.models.polar.encode import PolarEncoder, Polar5GEncoder
from polar_torch.models.polar.sc import PolarSCDecoder
from polar_torch.models.polar.scl import PolarSCLDecoder
from polar_torch.models.polar.hybrid import HybridSCLDecoder
from polar_torch.models.polar.bp import PolarBPDecoder
from polar_torch.models.polar.decode5g import Polar5GDecoder
from polar_torch.models.polar.dense import (DenseKernelDecoder,
                                            DenseKernelEncoder, gf2_inv)
