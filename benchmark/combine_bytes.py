"""Byte model of the port's embedding combine and its backward.

Frozen yardstick. The least traffic of C1/C2, the ``occ_`` kernels of
``csrc/occ_combine.cu``, over the steps of one physical table, each
input byte read once and each output byte written once:

* forward: each real occurrence's row (4 x dim bytes) and 17 bytes an
  occurrence (its row index, mask, scale and sort key), and each output
  element written (4 bytes: B x dim a bag column, B x L x dim a
  sequence column, its padded positions written as zeros);
* backward: each real occurrence's output gradient (4 x dim bytes) and
  16 bytes an occurrence (its sorted key and position), and each
  distinct row's gradient written (4 x dim bytes).

The backward's stable sort of the occurrences' keys is ``torch.sort``'s,
whose kernels other sorts of a step share by name; it is left out, as
the time it is set against leaves it out. Padding is no occurrence: a
padded position costs only its output's zeros.
"""

from __future__ import annotations

from typing import Iterable, Tuple

ELEMENT_BYTES = 4
FORWARD_OCC_BYTES = 17
BACKWARD_OCC_BYTES = 16


def out_elements(columns: Iterable[Tuple[int, int]], samples: int) -> int:
    """Output elements of ``samples`` samples of ``columns``, each given
    as ``(dim, positions)``: 1 position for a bag, L for a sequence."""
    return samples * sum(dim * n for dim, n in columns)


def combine_bytes(tables: Iterable[Tuple[int, int, int]],
                  out_elems: int) -> int:
    """Forward and backward bytes of ``tables``, each given as ``(dim,
    occurrences, distinct)``: its real ids and its distinct rows (each
    step's distinct keys, summed over the steps), with ``out_elems``
    output elements of their columns."""
    return ELEMENT_BYTES * out_elems + sum(
        occ * (2 * ELEMENT_BYTES * dim + FORWARD_OCC_BYTES
               + BACKWARD_OCC_BYTES) + ELEMENT_BYTES * dim * distinct
        for dim, occ, distinct in tables)
