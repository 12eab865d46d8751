"""Carry precomputed tables across to the port: the counterpart of
converting a model's weights.

The skimmer has no trained weights; what the JAX package precomputes on
the host instead are tables: the channelizer's filter segments and NCO
tone basis, the decoder's DFT matrix and analysis window, Gray bitmaps,
CRC matrix, data-symbol index, AP mask and values, BP index tables,
systematic generator, payload-hash weights and OSD flip patterns; WSPR's
block-code matrices, interleaver and sync vector; the q-ary modes' sync
index, interleaver and Gray demap, the GF(64) and RS(63,12) tables, and
the Q65 code's sum-product tables.

:func:`tables_to_torch` takes such tables as NumPy arrays — read off the
JAX objects, or built by the port's own constructors — checks each against
the schema below, and returns tensors on ``device``.  The port's decoder
moves its own tables with it; the tests feed it the JAX package's tables
and require them bit for bit equal to the port's, so the machine with the
card never needs JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from cwsl_digi_tpu_torch.device import as_device

# table name -> dtype it must already have (no silent casts)
TABLE_DTYPES: dict[str, np.dtype] = {
    # channelizer (dsp/channelizer.py)
    "segs": np.dtype(np.float32),        # [BS, NWS] filter segments
    "tone_re": np.dtype(np.float32),     # [C, SUB] NCO tone basis
    "tone_im": np.dtype(np.float32),
    # GFSK decoders (modes/gfsk_engine.py, modes/ldpc.py, modes/osd.py);
    # shapes for FT8, whose code is LDPC(174,91) with 77 + 14 info bits
    # (JS8: LDPC(174,87), 75 + 12; FST4/FST4W: LDPC(240,101), 77 + 24)
    "dft_mat": np.dtype(np.float32),     # [sps, 4*n_bins] DFT columns
                                         # (absent on the rfft branch)
    "window": np.dtype(np.float32),      # [sps] Hann window
    "bitmaps": np.dtype(np.float32),     # [bits_per_sym, n_tones]
    "crc_mat": np.dtype(np.float32),     # [77, 14]
    "data_syms": np.dtype(np.int32),     # [58]
    "ap_mask": np.dtype(np.float32),     # [H, 174]
    "ap_vals": np.dtype(np.float32),     # [H, 174]
    "row_cols": np.dtype(np.int32),      # [83, max_row] BP tables
    "row_mask": np.dtype(np.float32),
    "col_slots": np.dtype(np.int32),     # [174, max_col]
    "col_mask": np.dtype(np.float32),
    "gen": np.dtype(np.uint8),           # [91, 174] systematic generator
    "gen_parity": np.dtype(np.float32),  # [91, 83]
    "hash_w": np.dtype(np.int32),        # [91] payload-hash weights
    "patterns": np.dtype(np.float32),    # [268, 91] OSD flip patterns
                                         # (WSPR: [740, 50])
    # WSPR (modes/wspr.py): the (162, 50) block view of the K=32 code
    "wspr_gen": np.dtype(np.uint8),      # [50, 162] generator G
    "wspr_inv": np.dtype(np.uint8),      # [162, 50] right inverse R
    "interleave": np.dtype(np.int32),    # [162] coded bit -> symbol
    "sync": np.dtype(np.int32),          # [162] sync vector
    # q-ary modes (modes/qary_engine.py), shapes for JT65
    "sync_syms": np.dtype(np.int32),     # [63] sync symbol indices
    "symbol_perm": np.dtype(np.int64),   # [63] interleave63
    "value_demap": np.dtype(np.int64),   # [64] inverse Gray code
    # RS(63,12) over GF(64) (modes/rs_device.py)
    "gf_mul": np.dtype(np.int64),        # [64, 64] multiplication table
    "gf_inv": np.dtype(np.int64),        # [64] inverses
    "rs_syn": np.dtype(np.int32),        # [51, 63] syndrome powers
    "rs_xi": np.dtype(np.int32),         # [63] position powers
    "rs_xi_inv": np.dtype(np.int32),     # [63]
    "rs_ch": np.dtype(np.int32),         # [52, 63] Chien powers
    "rs_xfcr": np.dtype(np.int32),       # [63] Forney factor
    # Q65's GF(64) code and sum-product decoder (modes/qra.py)
    "h_vars": np.dtype(np.int32),        # [50, max_row] variable per slot
    "h_coeff": np.dtype(np.int32),       # [50, max_row] GF coefficient
    "qra_fwd": np.dtype(np.int64),       # [50, max_row, 64] permutations
    "qra_bwd": np.dtype(np.int64),
    "wht": np.dtype(np.float32),         # [64, 64] Walsh-Hadamard matrix
}


def tables_to_torch(tables: Mapping[str, np.ndarray],
                    device: torch.device | str | None = None
                    ) -> dict[str, torch.Tensor]:
    """NumPy tables -> tensors on ``device`` (default: the card), each
    checked by name and dtype; raises on an unknown name or a dtype that
    differs."""
    device = as_device(device)
    out = {}
    for name, arr in tables.items():
        want = TABLE_DTYPES.get(name)
        if want is None:
            raise KeyError(f"unknown table {name!r}")
        a = np.asarray(arr)
        if a.dtype != want:
            raise ValueError(f"table {name!r}: dtype {a.dtype}, expected {want}")
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:       # e.g. a view of a JAX array
            a = a.copy()
        out[name] = torch.from_numpy(a).to(device)
    return out
