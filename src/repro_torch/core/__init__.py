# The paper's analysis machinery beside its system (core/system.py): the
# sequential-idealization bottleneck breakdown and the CPU/GPU-ratio
# provisioning metric.
from repro_torch.core.bottleneck import (RooflineTerms, paper_fig2_reference,  # noqa: F401
                                         sequential_idealization, terms_from_hlo)
from repro_torch.core.provisioning import (DeratingModel, OnPolicyPoint,  # noqa: F401
                                           Provisioning, RatioBreakdown, SystemModel,
                                           cpu_gpu_ratio, cpu_gpu_ratio_breakdown,
                                           fit_paper_actor_model, fit_paper_derating,
                                           provision)
