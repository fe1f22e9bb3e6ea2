from fvd_tpu_torch.runtime.dag import DAG, NodeSpec  # noqa: F401
from fvd_tpu_torch.runtime.scheduler import Scheduler, NodeEvent  # noqa: F401
from fvd_tpu_torch.runtime.status import StatusBoard  # noqa: F401
from fvd_tpu_torch.runtime.debug import dump_node_debug  # noqa: F401
from fvd_tpu_torch.runtime.tracer import Tracer, get_tracer, set_tracer  # noqa: F401
