from repro_torch.optim.adamw import Optimizer, adamw, apply_updates, sgd  # noqa: F401
from repro_torch.optim.schedule import cosine_schedule, linear_warmup  # noqa: F401
