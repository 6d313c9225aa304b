"""Serving: the continuous-batching engine over a paged KV cache.

Counterpart of ``flashmoe_tpu/serving/``:

* :mod:`~flashmoe_tpu_torch.serving.kvcache`: the paged KV cache (block
  tables over a fixed page pool, LIFO page reuse, bucketed gathers);
* :mod:`~flashmoe_tpu_torch.serving.engine`: the engine (admission,
  eviction, chunked prefill, speculative decoding, EP-sharded decode);
* :mod:`~flashmoe_tpu_torch.serving.speculate`: the n-gram drafter;
* :mod:`~flashmoe_tpu_torch.serving.loadgen`: the seeded request trace
  and its per-replica split;
* :mod:`~flashmoe_tpu_torch.serving.pools`: the prefill/decode pool split
  (inference-mode Decider groups), which :mod:`flashmoe_tpu_torch.fabric`
  composes with a KV handoff and a replica router into the serving
  fabric.

CLI: ``python -m flashmoe_tpu_torch.serving`` drives a seeded drill on
the card (``--device cpu`` on the CPU) and prints one JSON summary line.
"""

from flashmoe_tpu_torch.serving.engine import (  # noqa: F401
    Request, ServeConfig, ServingEngine,
)
from flashmoe_tpu_torch.serving.kvcache import (  # noqa: F401
    PagedKVCache, PagePool, SCRATCH_PAGE, ShardedPagePool,
    init_paged_cache,
)
from flashmoe_tpu_torch.serving.pools import (  # noqa: F401
    PoolPlan, plan_serving_pools,
)
