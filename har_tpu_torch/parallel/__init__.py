"""The parallel layer: meshes of ranks and the single-controller serving
mesh, placements, data- and tensor-parallel steps, ZeRO-1, ring
attention, expert and pipeline parallelism.

Port of ``har_tpu/parallel`` (``mesh``, ``sharding``, ``rules``,
``data_parallel``, ``tensor_parallel``, ``zero1``, ``ring_attention``,
``expert_parallel``, ``pipeline_parallel``).

Design.  JAX builds one single-controller ``Mesh`` over ``jax.devices()``
and compiles each step as one SPMD program.  PyTorch's idiom is one
process per device: a mesh here is a ``torch.distributed`` ``DeviceMesh``
over the process group that spans it (``nccl`` on CUDA, ``gloo`` on the
CPU), with the axis names ``("dp", "tp")`` or ``("dp_dcn", "dp", "tp")``.

- ``dp × tp`` must equal the group's world size (``create_mesh`` raises a
  ``ValueError`` that names ``--distributed`` and ``torchrun``); the
  runner takes a ``dp × tp == 1`` mesh as no mesh and trains on one
  device, as the JAX runner does.
- Inputs are replicated: every rank holds the whole ``x``, ``y`` and batch
  schedule and takes its data shard of each batch.  The loss sum, the
  weight sum and the gradients are all-reduced over the data axes, so
  padded rows (weight 0) count for nothing.
- On a ``tp`` axis the parameters are DTensors placed as the JAX trainer
  places them (``dense_alternating_specs``) or by a rule table
  (``rules``), and DTensor propagates the collectives the layout implies;
  kernel K2 runs on each rank's local tensors through ``local_map``.
- ZeRO-1 shards AdamW's moments over the flat parameter vector; the ring
  rotates K/V with ``batch_isend_irecv`` and runs K2 with its lse per hop.
- ``data_shard_count`` / ``model_shard_count`` read only the mesh's shape
  (a ``DeviceMesh``, a ``ServingMesh`` or a mapping), with no collective.
- MoE (``expert_parallel``) exchanges tokens with an autograd-capable
  ``all_to_all_single`` over a 1-D ``ep`` mesh of ranks; the GPipe
  schedule (``pipeline_parallel``) rotates activations with
  ``batch_isend_irecv`` over a 1-D ``pp`` mesh.

Serving is single-controller, as in the JAX package: one engine process
drives every device of a ``ServingMesh`` (``create_serving_mesh``), a
grid of ``torch.device`` objects with no process group; the rule tables
place a served model's weights on it (``rules.place_local``), and
``serve.dispatch``'s ``ShardedScorer`` / ``ModelParallelScorer`` launch on
each device.  Several rank processes each running the engine would batch
by their own clocks and part ways in the collectives.
"""

from har_tpu_torch.parallel.mesh import (
    DP_AXIS,
    DP_DCN_AXIS,
    TP_AXIS,
    axis_group,
    create_mesh,
    create_multihost_mesh,
    data_axes,
    data_shard_count,
    initialize_distributed,
    linear_data_shard_index,
    linear_mesh,
    model_shard_count,
    ServingMesh,
    create_serving_mesh,
    serving_devices,
    single_device_mesh,
    use_mesh,
)
from har_tpu_torch.parallel.sharding import (
    batch_sharding,
    pad_to_multiple,
    replicated,
    shard_batch,
)
from har_tpu_torch.parallel.data_parallel import jit_replicated, make_dp_train_step
from har_tpu_torch.parallel.rules import (
    DENSE_MLP_RULES,
    INT8_RULES,
    MOE_RULES,
    PIPELINE_RULES,
    RULE_TABLES,
    TRANSFORMER_RULES,
    P,
    PartitionSpec,
    alternating_rules,
    make_shard_and_gather_fns,
    make_shard_fns,
    match_partition_rules,
    match_rule,
    place_local,
    rules_for_params,
)
from har_tpu_torch.parallel.tensor_parallel import (
    dense_alternating_specs,
    make_gspmd_scan_fit,
    make_gspmd_train_step,
    shard_params,
)
from har_tpu_torch.parallel.zero1 import Zero1Trainer, make_zero1_fit
from har_tpu_torch.parallel.ring_attention import (
    full_attention,
    ring_attention,
    ring_flash_attention,
    ring_hop,
)
from har_tpu_torch.parallel.pipeline_parallel import (
    PP_AXIS,
    make_pipeline_fn,
    pipeline_mesh,
    stack_stage_params,
)
from har_tpu_torch.parallel.expert_parallel import (
    EP_AXIS,
    dropless_capacity,
    expert_mesh,
    init_moe_params,
    make_moe_fn,
    moe_dense_reference,
)

__all__ = [
    "DENSE_MLP_RULES",
    "INT8_RULES",
    "MOE_RULES",
    "PIPELINE_RULES",
    "RULE_TABLES",
    "TRANSFORMER_RULES",
    "P",
    "PartitionSpec",
    "alternating_rules",
    "make_shard_and_gather_fns",
    "make_shard_fns",
    "match_partition_rules",
    "match_rule",
    "place_local",
    "rules_for_params",
    "DP_AXIS",
    "DP_DCN_AXIS",
    "TP_AXIS",
    "axis_group",
    "create_mesh",
    "create_multihost_mesh",
    "data_axes",
    "data_shard_count",
    "initialize_distributed",
    "linear_data_shard_index",
    "linear_mesh",
    "model_shard_count",
    "ServingMesh",
    "create_serving_mesh",
    "serving_devices",
    "single_device_mesh",
    "use_mesh",
    "batch_sharding",
    "pad_to_multiple",
    "replicated",
    "shard_batch",
    "jit_replicated",
    "make_dp_train_step",
    "dense_alternating_specs",
    "make_gspmd_scan_fit",
    "make_gspmd_train_step",
    "shard_params",
    "Zero1Trainer",
    "make_zero1_fit",
    "full_attention",
    "ring_attention",
    "ring_flash_attention",
    "ring_hop",
    "PP_AXIS",
    "make_pipeline_fn",
    "pipeline_mesh",
    "stack_stage_params",
    "EP_AXIS",
    "dropless_capacity",
    "expert_mesh",
    "init_moe_params",
    "make_moe_fn",
    "moe_dense_reference",
]
