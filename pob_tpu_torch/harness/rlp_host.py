"""Minimal host-side RLP codec (encode ints/bytes/lists, decode to bytes/
lists). Used by the input generator for block-header assembly and MPT leaf
parsing — the role the external `rlp` package plays in the reference harness
(tests/main.py:3,86-122)."""

from __future__ import annotations


def encode(item) -> bytes:
    if isinstance(item, int):
        item = b"" if item == 0 else item.to_bytes((item.bit_length() + 7) // 8, "big")
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        if len(item) <= 55:
            return bytes([0x80 + len(item)]) + item
        ln = len(item).to_bytes((len(item).bit_length() + 7) // 8, "big")
        return bytes([0xB7 + len(ln)]) + ln + item
    payload = b"".join(encode(x) for x in item)
    if len(payload) <= 55:
        return bytes([0xC0 + len(payload)]) + payload
    ln = len(payload).to_bytes((len(payload).bit_length() + 7) // 8, "big")
    return bytes([0xF7 + len(ln)]) + ln + payload


def decode(data: bytes):
    item, rest = _decode_one(bytes(data))
    if rest:
        raise ValueError("trailing RLP bytes")
    return item


def _decode_one(d: bytes):
    if not d:
        raise ValueError("empty RLP")
    b0 = d[0]
    if b0 < 0x80:
        return d[:1], d[1:]
    if b0 <= 0xB7:
        n = b0 - 0x80
        return d[1 : 1 + n], d[1 + n :]
    if b0 <= 0xBF:
        ln = b0 - 0xB7
        n = int.from_bytes(d[1 : 1 + ln], "big")
        return d[1 + ln : 1 + ln + n], d[1 + ln + n :]
    if b0 <= 0xF7:
        n = b0 - 0xC0
        payload = d[1 : 1 + n]
        rest = d[1 + n :]
    else:
        ln = b0 - 0xF7
        n = int.from_bytes(d[1 : 1 + ln], "big")
        payload = d[1 + ln : 1 + ln + n]
        rest = d[1 + ln + n :]
    items = []
    while payload:
        item, payload = _decode_one(payload)
        items.append(item)
    return items, rest
