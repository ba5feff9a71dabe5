"""Convert a .dc checkpoint to a VTK file — the analogue of the
reference's examples/dc2vtk.cpp (VisIt/ParaView workflow,
examples/README:20-35).

The payload spec is given on the command line as name:dtype[:shape] items,
e.g.  ``python -m dccrg_tpu_torch.examples.dc2vtk run.dc out.vtk density:f8
mom:f8:3``.
"""
import sys

import numpy as np

from dccrg_tpu_torch import Grid
from dccrg_tpu_torch.examples import parser


def parse_spec(items):
    spec = {}
    for item in items:
        parts = item.split(":")
        name, dtype = parts[0], np.dtype(parts[1])
        shape = tuple(int(v) for v in parts[2:])
        spec[name] = (shape, dtype)
    return spec


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("spec", nargs="+", help="name:dtype[:shape] items")
    args = ap.parse_args(argv)
    src, dst = args.src, args.dst
    spec = parse_spec(args.spec)
    grid, state, header = Grid.load_grid_data(src, spec, n_devices=1,
                                              device=args.device)
    cells = grid.get_cells()
    scalars = {}
    for name, (shape, _) in spec.items():
        vals = grid.get_cell_data(state, name, cells)
        if shape == ():
            scalars[name] = vals
        else:
            flat = vals.reshape(len(cells), -1)
            for i in range(flat.shape[1]):
                scalars[f"{name}_{i}"] = flat[:, i]
    grid.write_vtk_file(dst, scalars=scalars)
    print(f"wrote {dst}: {len(cells)} cells, fields {list(scalars)}")
    with open(dst, "rb") as f:
        body = f.read()
    assert f"CELL_DATA {len(cells)}\n".encode() in body, "no cell data"
    for name in scalars:
        assert f"SCALARS {name} ".encode() in body, name
    print(f"PASSED: {len(cells)} cells and {len(scalars)} fields in {dst}")


if __name__ == "__main__":
    sys.exit(main())
