"""Neural-net zoo — port of ``myria3d_tpu/models/modules/__init__.py``.

``MODEL_ZOO`` and the substring-matched factory ``get_neural_net_class``
keep the reference's extension point for architecture swaps
(``myria3d/models/model.py:12-29``). The JAX package's two families come
first; Point Transformer (``point_transformer.py``) and Point Transformer V3
(``point_transformer_v3.py``) are the port's own. The nets are imported on first use:
the ops import ``models.modules.nn``, which runs this package first.
"""


def _zoo() -> list:
    from myria3d_tpu_torch.models.modules.point_transformer import PointTransformerSeg
    from myria3d_tpu_torch.models.modules.point_transformer_v3 import PointTransformerV3Seg
    from myria3d_tpu_torch.models.modules.pointnet2 import PointNet2
    from myria3d_tpu_torch.models.modules.randla_net import RandLANet

    return [RandLANet, PointNet2, PointTransformerSeg, PointTransformerV3Seg]


def __getattr__(name: str):
    if name == "MODEL_ZOO":
        return _zoo()
    raise AttributeError(name)


def get_neural_net_class(class_name: str):
    """Find a neural-net class by (sub)name — reference ``model.py:15-29``."""
    for neural_net_class in _zoo():
        if class_name in neural_net_class.__name__:
            return neural_net_class
    raise KeyError(f"Unknown class name {class_name}")
