"""The detector configuration as the reference reads it: the ``config``
object of a ``pillarbench/configs/<name>.json`` file (the fields of the
port's ``PillarsConfig``, classes as a list of objects)."""

from __future__ import annotations

from types import SimpleNamespace


class RefConfig(SimpleNamespace):
    """The fields of a config file's ``config`` object, with the derived
    shapes the reference needs."""

    def __init__(self, fields: dict):
        super().__init__(**{k: v for k, v in fields.items()
                            if k != "classes"})
        self.classes = tuple(SimpleNamespace(**c) for c in fields["classes"])
        self.rpn_channels = tuple(self.rpn_channels)
        self.rpn_layers = tuple(self.rpn_layers)
        self.anchor_yaws = tuple(self.anchor_yaws)

    @property
    def grid_w(self) -> int:
        return int(round((self.x_max - self.x_min) / self.voxel_x))

    @property
    def grid_h(self) -> int:
        return int(round((self.y_max - self.y_min) / self.voxel_y))

    @property
    def feature_w(self) -> int:
        return self.grid_w // self.head_stride

    @property
    def feature_h(self) -> int:
        return self.grid_h // self.head_stride

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    @property
    def anchors_per_loc(self) -> int:
        return self.num_classes * len(self.anchor_yaws)

    @property
    def num_anchors(self) -> int:
        return self.feature_h * self.feature_w * self.anchors_per_loc

    @property
    def num_input_features(self) -> int:
        return self.num_raw_features + (1 if self.num_sweeps > 1 else 0)

    @property
    def num_decorated_features(self) -> int:
        return self.num_input_features + 5
