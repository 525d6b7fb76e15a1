from repro_torch.configs.shapes import SHAPES, shape_cells, InputShape  # noqa: F401
