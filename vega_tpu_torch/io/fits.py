"""Minimal pure-numpy FITS reader/writer.

The reference framework (vega) relies on astropy.io.fits for all of its
data I/O (reference: data.py:285-420, vega_interface.py:666-703,
output.py). This module provides the subset of FITS needed here without
external dependencies: primary HDUs, binary-table extensions, and image
extensions, with transparent gzip support.

Only init-time I/O goes through this module; nothing here touches the
device hot path. A copy of vega_tpu/io/fits.py, pinned to it by the
equality tests in tests/test_torch_host.py.
"""

from __future__ import annotations

import gzip
import io as _io
from pathlib import Path

import numpy as np

BLOCK = 2880
CARD = 80

# FITS binary-table format codes -> numpy big-endian dtypes
_TFORM_DTYPES = {
    'L': '>i1',   # logical, stored as 'T'/'F' bytes; decoded specially
    'X': '>u1',   # bit array (raw bytes)
    'B': '>u1',
    'I': '>i2',
    'J': '>i4',
    'K': '>i8',
    'E': '>f4',
    'D': '>f8',
    'C': '>c8',
    'M': '>c16',
    'A': 'S',     # character
}

_INV_TFORM = {
    np.dtype('bool'): 'L',
    np.dtype('uint8'): 'B',
    np.dtype('int16'): 'I',
    np.dtype('int32'): 'J',
    np.dtype('int64'): 'K',
    np.dtype('float32'): 'E',
    np.dtype('float64'): 'D',
    np.dtype('complex64'): 'C',
    np.dtype('complex128'): 'M',
}


class Header(dict):
    """FITS header as a dict with attribute-ish convenience."""

    def __init__(self):
        super().__init__()
        self.comments = {}


def _parse_card(card: str, header: Header):
    key = card[:8].strip()
    if key in ('', 'COMMENT', 'HISTORY', 'END'):
        return key
    if card[8:10] != '= ':
        return key
    rest = card[10:]
    # String value
    if rest.lstrip().startswith("'"):
        s = rest.lstrip()
        out = []
        i = 1
        while i < len(s):
            if s[i] == "'":
                if i + 1 < len(s) and s[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(s[i])
            i += 1
        header[key] = ''.join(out).rstrip()
        return key
    # Split off comment
    val = rest.split('/', 1)[0].strip()
    if val in ('T', 'F'):
        header[key] = (val == 'T')
    else:
        try:
            header[key] = int(val)
        except ValueError:
            try:
                header[key] = float(val)
            except ValueError:
                header[key] = val
    return key


def _read_header(buf) -> Header | None:
    header = Header()
    while True:
        block = buf.read(BLOCK)
        if len(block) == 0:
            return None
        if len(block) < BLOCK:
            raise ValueError('Truncated FITS header block')
        text = block.decode('ascii', errors='replace')
        done = False
        for i in range(0, BLOCK, CARD):
            card = text[i:i + CARD]
            key = _parse_card(card, header)
            if key == 'END':
                done = True
                break
        if done:
            return header


def _parse_tform(tform: str):
    """Parse a TFORM code like '2500D' -> (repeat, code)."""
    tform = tform.strip()
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    repeat = int(tform[:i]) if i > 0 else 1
    code = tform[i]
    return repeat, code


class TableHDU:
    """A FITS binary table HDU (columns of possibly-array cells)."""

    def __init__(self, header: Header, columns: dict[str, np.ndarray], name=''):
        self.header = header
        self.columns = columns
        self.name = name

    @property
    def data(self):
        return self

    def __getitem__(self, key):
        return self.columns[key]

    def __contains__(self, key):
        return key in self.columns

    @property
    def column_names(self):
        return list(self.columns.keys())


class ImageHDU:
    def __init__(self, header: Header, data, name=''):
        self.header = header
        self.data = data
        self.name = name


def _read_table_data(buf, header: Header) -> dict[str, np.ndarray]:
    nrows = header['NAXIS2']
    rowbytes = header['NAXIS1']
    nfields = header['TFIELDS']

    names, dtypes = [], []
    for i in range(1, nfields + 1):
        name = str(header.get(f'TTYPE{i}', f'col{i}')).strip()
        repeat, code = _parse_tform(str(header[f'TFORM{i}']))
        if code == 'A':
            dt = (f'S{repeat}',)
        elif code == 'P' or code == 'Q':
            raise NotImplementedError('Variable-length FITS columns not supported')
        else:
            base = _TFORM_DTYPES[code]
            dt = (base, (repeat,)) if repeat != 1 else (base,)
        names.append(name)
        dtypes.append(dt)

    rec_dtype = np.dtype({
        'names': names,
        'formats': [d[0] if len(d) == 1 else d for d in dtypes],
    })
    if rec_dtype.itemsize != rowbytes:
        raise ValueError(
            f'Row size mismatch: computed {rec_dtype.itemsize}, NAXIS1={rowbytes}')

    nbytes = nrows * rowbytes
    raw = buf.read(nbytes)
    if len(raw) < nbytes:
        raise ValueError('Truncated FITS table data')
    # Skip padding
    pad = (-nbytes) % BLOCK
    buf.read(pad)

    rec = np.frombuffer(raw, dtype=rec_dtype, count=nrows)
    columns = {}
    for i, name in enumerate(names):
        col = rec[name]
        _, code = _parse_tform(str(header[f'TFORM{i + 1}']))
        if code == 'L':
            col = (col == ord('T'))
        elif code == 'A':
            col = np.char.decode(col.astype(np.bytes_), 'ascii')
        else:
            col = col.astype(col.dtype.newbyteorder('='))
        columns[name] = col
    return columns


def _read_image_data(buf, header: Header):
    bitpix = header['BITPIX']
    naxis = header['NAXIS']
    if naxis == 0:
        return None
    shape = tuple(header[f'NAXIS{i}'] for i in range(naxis, 0, -1))
    dtype = {8: '>u1', 16: '>i2', 32: '>i4', 64: '>i8',
             -32: '>f4', -64: '>f8'}[bitpix]
    count = int(np.prod(shape))
    nbytes = count * abs(bitpix) // 8
    raw = buf.read(nbytes)
    if len(raw) < nbytes:
        raise ValueError('Truncated FITS image data')
    buf.read((-nbytes) % BLOCK)
    arr = np.frombuffer(raw, dtype=dtype, count=count).reshape(shape)
    return arr.astype(arr.dtype.newbyteorder('='))


def read_fits(path) -> list:
    """Read all HDUs of a FITS file (optionally .gz) into a list.

    Mirrors the access patterns vega uses with astropy
    (reference: data.py:302, vega_interface.py:690).
    """
    path = Path(path)
    if str(path).endswith('.gz'):
        with gzip.open(path, 'rb') as f:
            buf = _io.BytesIO(f.read())
    else:
        buf = _io.BytesIO(path.read_bytes())

    hdus = []
    while True:
        header = _read_header(buf)
        if header is None:
            break
        xtension = str(header.get('XTENSION', '')).strip()
        name = str(header.get('EXTNAME', '')).strip()
        if xtension == 'BINTABLE':
            cols = _read_table_data(buf, header)
            hdus.append(TableHDU(header, cols, name))
        else:
            data = _read_image_data(buf, header)
            hdus.append(ImageHDU(header, data, name))
    return hdus


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _format_card(key: str, value, comment: str = '') -> str:
    if isinstance(value, bool):
        v = 'T' if value else 'F'
        card = f'{key:<8}= {v:>20}'
    elif isinstance(value, (int, np.integer)):
        card = f'{key:<8}= {value:>20d}'
    elif isinstance(value, (float, np.floating)):
        card = f'{key:<8}= {value!r:>20}'
    else:
        s = str(value).replace("'", "''")
        card = f"{key:<8}= '{s:<8}'"
    if comment:
        card += f' / {comment}'
    return card[:CARD].ljust(CARD)


def _pad_block(data: bytes, fill=b'\x00') -> bytes:
    pad = (-len(data)) % BLOCK
    return data + fill * pad


def _header_bytes(cards: list[str]) -> bytes:
    text = ''.join(cards) + 'END'.ljust(CARD)
    return _pad_block(text.encode('ascii'), fill=b' ')


def _column_tform(arr: np.ndarray):
    """Get (tform, big-endian dtype) for a table column array."""
    if arr.dtype.kind in ('U', 'S'):
        width = arr.dtype.itemsize // (4 if arr.dtype.kind == 'U' else 1)
        return f'{width}A', f'S{width}'
    base = np.dtype(arr.dtype.newbyteorder('='))
    code = _INV_TFORM[base]
    repeat = int(np.prod(arr.shape[1:])) if arr.ndim > 1 else 1
    tform = f'{repeat}{code}' if repeat != 1 else code
    return tform, base.newbyteorder('>')


def write_fits(path, hdus: list, overwrite: bool = True):
    """Write a FITS file from a list of HDU specs.

    Each element is a dict: {'name': str, 'header': dict, 'columns': dict}
    for a binary table, or {'name': str, 'header': dict, 'image': array}.
    A minimal primary HDU is always prepended.
    """
    path = Path(path)
    if path.exists() and not overwrite:
        raise FileExistsError(path)

    out = bytearray()
    # Primary HDU
    cards = [
        _format_card('SIMPLE', True, 'conforms to FITS standard'),
        _format_card('BITPIX', 8),
        _format_card('NAXIS', 0),
        _format_card('EXTEND', True),
    ]
    out += _header_bytes(cards)

    for hdu in hdus:
        name = hdu.get('name', '')
        header = hdu.get('header', {}) or {}
        if 'columns' in hdu:
            columns = {
                k: (np.asarray(v) if np.asarray(v).ndim > 0
                    else np.asarray(v)[None])
                for k, v in hdu['columns'].items()
            }
            nrows = len(next(iter(columns.values()))) if columns else 0
            parts, cards = [], []
            tforms = []
            for cname, arr in columns.items():
                if arr.dtype.kind == 'b':
                    arr = np.where(arr, ord('T'), ord('F')).astype('u1')
                    tform, dt = 'L', '>u1'
                elif arr.dtype.kind == 'U':
                    arr = np.char.encode(arr, 'ascii')
                    tform, dt = _column_tform(arr)
                else:
                    tform, dt = _column_tform(arr)
                tforms.append(tform)
                parts.append(np.ascontiguousarray(arr.reshape(nrows, -1),
                                                  dtype=dt))
            rowbytes = sum(p.dtype.itemsize * p.shape[1] for p in parts)
            cards = [
                _format_card('XTENSION', 'BINTABLE', 'binary table extension'),
                _format_card('BITPIX', 8),
                _format_card('NAXIS', 2),
                _format_card('NAXIS1', rowbytes),
                _format_card('NAXIS2', nrows),
                _format_card('PCOUNT', 0),
                _format_card('GCOUNT', 1),
                _format_card('TFIELDS', len(columns)),
            ]
            for i, (cname, tform) in enumerate(zip(columns, tforms), start=1):
                cards.append(_format_card(f'TTYPE{i}', cname))
                cards.append(_format_card(f'TFORM{i}', tform))
            if name:
                cards.append(_format_card('EXTNAME', name))
            for key, val in header.items():
                cards.append(_format_card(str(key)[:8].upper(), val))
            out += _header_bytes(cards)
            if nrows:
                row_arrays = [p.view('u1').reshape(nrows, -1) for p in parts]
                data = np.concatenate(row_arrays, axis=1).tobytes()
            else:
                data = b''
            out += _pad_block(data)
        else:
            arr = np.asarray(hdu['image'])
            bitpix = {'u1': 8, 'i2': 16, 'i4': 32, 'i8': 64,
                      'f4': -32, 'f8': -64}[arr.dtype.str[1:]]
            cards = [
                _format_card('XTENSION', 'IMAGE', 'image extension'),
                _format_card('BITPIX', bitpix),
                _format_card('NAXIS', arr.ndim),
            ]
            for i, n in enumerate(reversed(arr.shape), start=1):
                cards.append(_format_card(f'NAXIS{i}', n))
            cards.append(_format_card('PCOUNT', 0))
            cards.append(_format_card('GCOUNT', 1))
            if name:
                cards.append(_format_card('EXTNAME', name))
            for key, val in header.items():
                cards.append(_format_card(str(key)[:8].upper(), val))
            out += _header_bytes(cards)
            out += _pad_block(arr.astype(arr.dtype.newbyteorder('>')).tobytes())

    path.write_bytes(bytes(out))
