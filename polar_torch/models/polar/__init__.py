from polar_torch.models.polar.construction import (
    gen_arikan,
    generate_5g_ranking,
    get_kern_frozen_bits,
)
from polar_torch.models.polar.encode import PolarEncoder, Polar5GEncoder
from polar_torch.models.polar.sc import PolarSCDecoder
from polar_torch.models.polar.scl import PolarSCLDecoder
from polar_torch.models.polar.hybrid import HybridSCLDecoder
from polar_torch.models.polar.bp import PolarBPDecoder
from polar_torch.models.polar.decode5g import Polar5GDecoder
