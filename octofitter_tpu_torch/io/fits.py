"""Minimal FITS binary-table reader/writer (no astropy dependency).

A copy of the numpy-only `octofitter_tpu/io/fits.py`: importing that
package would import JAX. It reads catalog BINTABLE extensions (the HGCA
FITS catalog that `likelihoods/hgca.py:load_hgca` reads, as the
reference's `src/likelihoods/hgca.jl:10-23` does) and writes them.

Implements the subset of the FITS standard used by those files:
8-bit-card ASCII headers in 2880-byte blocks, primary HDU, BINTABLE
extensions with TFORM codes L, B, I, J, K, E, D, A (scalars and fixed
repeat counts), big-endian data.
"""

from __future__ import annotations

import io
import numpy as np

_BLOCK = 2880
_CARD = 80

_TFORM_DTYPES = {
    "L": ("u1", 1),
    "B": ("u1", 1),
    "I": (">i2", 2),
    "J": (">i4", 4),
    "K": (">i8", 8),
    "E": (">f4", 4),
    "D": (">f8", 8),
}


def _parse_header(f):
    cards = {}
    order = []
    while True:
        block = f.read(_BLOCK)
        if len(block) < _BLOCK:
            raise EOFError("truncated FITS header")
        end_found = False
        for i in range(0, _BLOCK, _CARD):
            card = block[i : i + _CARD].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                end_found = True
                break
            if not key or key in ("COMMENT", "HISTORY"):
                continue
            if card[8:10] != "= ":
                continue
            val = card[10:].split("/")[0].strip()
            if val.startswith("'"):
                v = val[1:].split("'")[0].rstrip()
            elif val == "T":
                v = True
            elif val == "F":
                v = False
            else:
                try:
                    v = int(val)
                except ValueError:
                    try:
                        v = float(val)
                    except ValueError:
                        v = val
            cards[key] = v
            order.append(key)
        if end_found:
            break
    return cards


def _skip_data(f, header):
    bitpix = abs(int(header.get("BITPIX", 8)))
    naxis = int(header.get("NAXIS", 0))
    size = 1 if naxis > 0 else 0
    for i in range(1, naxis + 1):
        size *= int(header[f"NAXIS{i}"])
    nbytes = size * bitpix // 8
    if header.get("XTENSION", "").startswith("BINTABLE"):
        nbytes += int(header.get("PCOUNT", 0))
    f.seek((nbytes + _BLOCK - 1) // _BLOCK * _BLOCK, io.SEEK_CUR)


_BITPIX_DTYPES = {8: ">u1", 16: ">i2", 32: ">i4", 64: ">i8",
                  -32: ">f4", -64: ">f8"}


def read_images(path):
    """Read every image HDU (primary + IMAGE extensions) as a list of
    2-D float64 numpy arrays, honoring BSCALE/BZERO and BLANK->NaN.
    Used for the reference's multi-extension direct-imaging fixtures
    (`docs/image-examples-1.fits`; `OctofitterImages` AstroImages.load)."""
    out = []
    with open(path, "rb") as f:
        while True:
            try:
                h = _parse_header(f)
            except Exception:
                break
            xtension = str(h.get("XTENSION", "")).strip()
            if xtension and not xtension.startswith("IMAGE"):
                # table/other extension: consume its data area (incl.
                # PCOUNT heap) so the next header parse stays aligned
                _skip_data(f, h)
                continue
            naxis = int(h.get("NAXIS", 0))
            if naxis == 0:
                continue
            shape = [int(h[f"NAXIS{i}"]) for i in range(naxis, 0, -1)]
            dtype = _BITPIX_DTYPES[int(h["BITPIX"])]
            count = int(np.prod(shape))
            nbytes = count * abs(int(h["BITPIX"])) // 8
            raw = f.read(nbytes)
            f.seek((-nbytes) % _BLOCK, 1)  # skip padding
            data = np.frombuffer(raw, dtype=dtype, count=count).reshape(shape)
            data = data.astype(np.float64)
            if "BLANK" in h and int(h["BITPIX"]) > 0:
                data[data == float(h["BLANK"])] = np.nan
            data = data * float(h.get("BSCALE", 1.0)) + float(h.get("BZERO", 0.0))
            if naxis == 2:
                out.append(data)
            elif naxis == 3:  # cube -> slices
                out.extend(list(data))
            else:
                out.append(data)
    return out


def _parse_tform(tform: str):
    tform = tform.strip()
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    repeat = int(tform[:i]) if i else 1
    code = tform[i]
    return repeat, code


def read_bintable(
    path, hdu: int | None = None, extname: str | None = None
) -> dict[str, np.ndarray]:
    """Read a BINTABLE HDU as a dict of column-name -> numpy array.

    hdu: extension index (1 = first extension). extname: select by the
    EXTNAME card (OIFITS-style, e.g. "OI_VIS2"). Default: first
    BINTABLE.
    """
    with open(path, "rb") as f:
        header = _parse_header(f)  # primary
        _skip_data(f, header)
        ext_i = 0
        while True:
            try:
                header = _parse_header(f)
            except Exception as e:
                raise KeyError(
                    f"no BINTABLE matching hdu={hdu} extname={extname!r} "
                    f"in {path}"
                ) from e
            ext_i += 1
            is_table = str(header.get("XTENSION", "")).startswith("BINTABLE")
            if extname is not None:
                if is_table and str(header.get("EXTNAME", "")).strip() == extname:
                    break
            elif (hdu is None and is_table) or (hdu is not None and ext_i == hdu):
                if not is_table:
                    raise ValueError(f"HDU {ext_i} is not a BINTABLE")
                break
            _skip_data(f, header)

        n_rows = int(header["NAXIS2"])
        row_bytes = int(header["NAXIS1"])
        n_cols = int(header["TFIELDS"])
        names, dtypes = [], []
        for i in range(1, n_cols + 1):
            name = str(header.get(f"TTYPE{i}", f"col{i}")).strip()
            repeat, code = _parse_tform(str(header[f"TFORM{i}"]))
            if code == "A":
                dt = (f"S{repeat}", repeat)
            elif code in _TFORM_DTYPES:
                base, width = _TFORM_DTYPES[code]
                dt = (base, width * repeat) if repeat == 1 else ((base, (repeat,)), width * repeat)
            else:
                raise NotImplementedError(f"TFORM code {code!r}")
            names.append(name)
            dtypes.append((code, repeat))

        np_dtype = []
        for name, (code, repeat) in zip(names, dtypes):
            if code == "A":
                np_dtype.append((name, f"S{repeat}"))
            else:
                base = _TFORM_DTYPES[code][0]
                if repeat == 1:
                    np_dtype.append((name, base))
                else:
                    np_dtype.append((name, base, (repeat,)))
        np_dtype = np.dtype(np_dtype)
        if np_dtype.itemsize != row_bytes:
            raise ValueError(
                f"row size mismatch: dtype {np_dtype.itemsize} vs NAXIS1 {row_bytes}"
            )
        raw = f.read(n_rows * row_bytes)
        rec = np.frombuffer(raw, dtype=np_dtype, count=n_rows)
        out = {}
        for name, (code, repeat) in zip(names, dtypes):
            col = rec[name]
            if code == "L":
                # FITS logical bytes: 'T' true; 'F' or 0 false
                out[name] = col == ord("T")
            elif code == "A":
                out[name] = np.char.decode(col, "ascii")
            else:
                out[name] = col.astype(col.dtype.newbyteorder("="))
        return out


def _card(key, value, comment=""):
    if isinstance(value, bool):
        v = "T" if value else "F"
        card = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        card = f"{key:<8}= {value:>20d}"
    elif isinstance(value, (float, np.floating)):
        card = f"{key:<8}= {value:>20.14G}"
    else:
        s = str(value).replace("'", "''")[:67]
        card = f"{key:<8}= '{s}'"
    if comment:
        card += f" / {comment}"
    return card[:80].ljust(80).encode("ascii")


def _pad_block(b: bytes, fill=b" ") -> bytes:
    pad = (-len(b)) % _BLOCK
    return b + fill * pad


def _bintable_bytes(table: dict, header_cards: dict | None = None) -> bytes:
    """Serialize one BINTABLE HDU. Columns may be 1-D (scalar per row)
    or 2-D (vector per row, TFORM repeat > 1, e.g. OIFITS wavelength
    axes)."""
    names = list(table.keys())
    cols = [np.asarray(table[n]) for n in names]
    n_rows = len(cols[0]) if cols else 0

    tforms, np_fields = [], []
    for n, c in zip(names, cols):
        rep = 1 if c.ndim == 1 else int(np.prod(c.shape[1:]))
        shape = () if c.ndim == 1 else c.shape[1:]
        if c.dtype.kind == "f":
            tforms.append(f"{rep}D" if rep != 1 else "D")
            np_fields.append((n, ">f8", shape))
        elif c.dtype.kind in "iu":
            tforms.append(f"{rep}K" if rep != 1 else "K")
            np_fields.append((n, ">i8", shape))
        elif c.dtype.kind in "US":
            width = max(1, int(np.char.str_len(c.astype(str)).max()))
            tforms.append(f"{width}A")
            np_fields.append((n, f"S{width}", shape))
        elif c.dtype.kind == "b":
            tforms.append(f"{rep}L" if rep != 1 else "L")
            np_fields.append((n, "u1", shape))
        else:
            raise NotImplementedError(f"column {n}: dtype {c.dtype}")
    rec = np.zeros(n_rows, dtype=np.dtype(np_fields))
    for n, c in zip(names, cols):
        if c.dtype.kind in "US":
            rec[n] = c.astype(str)
        elif c.dtype.kind == "b":
            # FITS logical: 'T'/'F' bytes
            rec[n] = np.where(c, ord("T"), ord("F"))
        else:
            rec[n] = c

    cards = [
        _card("XTENSION", "BINTABLE", "binary table extension"),
        _card("BITPIX", 8),
        _card("NAXIS", 2),
        _card("NAXIS1", rec.dtype.itemsize),
        _card("NAXIS2", n_rows),
        _card("PCOUNT", 0),
        _card("GCOUNT", 1),
        _card("TFIELDS", len(names)),
    ]
    for i, (n, tf) in enumerate(zip(names, tforms), start=1):
        cards.append(_card(f"TTYPE{i}", n))
        cards.append(_card(f"TFORM{i}", tf))
    for k, v in (header_cards or {}).items():
        cards.append(_card(str(k)[:8].upper(), v))
    cards.append(b"END".ljust(80))
    return _pad_block(b"".join(cards)) + _pad_block(rec.tobytes(), fill=b"\x00")


def _primary_bytes() -> bytes:
    prim = b"".join(
        [
            _card("SIMPLE", True, "conforms to FITS standard"),
            _card("BITPIX", 8),
            _card("NAXIS", 0),
            _card("EXTEND", True),
            b"END".ljust(80),
        ]
    )
    return _pad_block(prim)


def write_bintable(path, table: dict, header_cards: dict | None = None):
    """Write a dict of arrays (float/int/str/bool; 1-D or 2-D) as a
    single-extension FITS BINTABLE file."""
    with open(path, "wb") as f:
        f.write(_primary_bytes())
        f.write(_bintable_bytes(table, header_cards))


def write_bintables(path, hdus):
    """Write multiple BINTABLE extensions to one FITS file.

    hdus: iterable of (table_dict, header_cards) — set EXTNAME in the
    cards to make extensions findable by name (OIFITS layout)."""
    with open(path, "wb") as f:
        f.write(_primary_bytes())
        for table, cards in hdus:
            f.write(_bintable_bytes(table, cards))


def read_header(path, hdu: int = 1) -> dict:
    """Return the header cards of the given HDU (0 = primary)."""
    with open(path, "rb") as f:
        header = _parse_header(f)
        i = 0
        while i < hdu:
            _skip_data(f, header)
            header = _parse_header(f)
            i += 1
        return header
