"""Minimal Go ``encoding/gob`` stream codec, decode and encode (a copy of
retina_tpu/sources/gobcodec.py).

Cilium's monitor unix socket speaks gob: the agent writes consecutive
gob-encoded ``payload.Payload`` values (``Data []byte, CPU int,
Lost uint64, Type int``) and Retina's ciliumeventobserver decodes them
(reference: pkg/plugin/ciliumeventobserver/ciliumeventobserver_linux.go
:155-180 ``monitorLoop`` — ``gob.NewDecoder(conn)`` +
``pl.DecodeBinary``). This module implements the subset of the gob wire
format needed to interoperate with that stream — struct, slice, array,
map, and all basic types — as a pure-Python incremental decoder plus a
matching encoder (tests, replay tooling, and serving a monitor-socket
clone).

Wire format implemented (per the gob specification, pkg.go.dev/encoding/gob):

- unsigned int: one byte if < 128, else (256 - byte_count) then
  big-endian bytes;
- signed int: unsigned carrier, bit 0 = "complement" flag;
- float: float64 bits byte-reversed, sent as unsigned;
- string/[]byte: length then raw bytes;
- slice/map: count then elements / key-value pairs;
- struct: (field delta, value)* terminated by delta 0; zero fields are
  omitted;
- message: length-prefixed; body = signed type id, then either a type
  descriptor (id < 0, a ``wireType`` value describing type ``-id``) or
  a value of that type (non-struct top-level values are preceded by one
  zero delta byte).

Self-check: ``tests/test_torch_cilium.py`` pins the worked ``Point{22,33}``
example from the gob documentation byte-for-byte.
"""

from __future__ import annotations

import struct as _struct
from typing import Any

# Bootstrap type ids (encoding/gob/type.go).
T_BOOL, T_INT, T_UINT, T_FLOAT = 1, 2, 3, 4
T_BYTES, T_STRING, T_COMPLEX, T_INTERFACE = 5, 6, 7, 8
T_WIRETYPE, T_ARRAYTYPE, T_COMMONTYPE, T_SLICETYPE = 16, 17, 18, 19
T_STRUCTTYPE, T_FIELDTYPE, T_FIELDSLICE, T_MAPTYPE = 20, 21, 22, 23
T_GOBENCODER, T_BINMARSHALER, T_TEXTMARSHALER = 24, 25, 26

FIRST_USER_ID = 65


class GobError(ValueError):
    pass


# ---------------------------------------------------------------------
# primitive readers/writers
# ---------------------------------------------------------------------
class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def byte(self) -> int:
        if self.pos >= len(self.buf):
            raise GobError("gob: truncated stream")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise GobError("gob: truncated stream")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def uint(self) -> int:
        b = self.byte()
        if b < 0x80:
            return b
        n = 256 - b
        if n > 8:
            raise GobError(f"gob: uint byte count {n} > 8")
        v = 0
        for c in self.take(n):
            v = (v << 8) | c
        return v

    def int_(self) -> int:
        u = self.uint()
        if u & 1:
            return ~(u >> 1)
        return u >> 1

def _float_from_uint(u: int) -> float:
    # gob reverses the byte order of the IEEE-754 bits so small
    # exponents encode short; undo the reversal here.
    return _struct.unpack("<d", u.to_bytes(8, "big"))[0]


class _Writer:
    __slots__ = ("parts",)

    def __init__(self) -> None:
        self.parts: list[bytes] = []

    def bytes_(self, b: bytes) -> None:
        self.parts.append(b)

    def uint(self, v: int) -> None:
        if v < 0x80:
            self.parts.append(bytes([v]))
            return
        raw = v.to_bytes((v.bit_length() + 7) // 8, "big")
        self.parts.append(bytes([256 - len(raw)]) + raw)

    def int_(self, v: int) -> None:
        if v < 0:
            self.uint((~v << 1) | 1)
        else:
            self.uint(v << 1)

    def float_(self, v: float) -> None:
        (bits,) = _struct.unpack(">Q", _struct.pack("<d", v))
        self.uint(bits)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


# ---------------------------------------------------------------------
# type table
# ---------------------------------------------------------------------
class _WType:
    """A registered wire type: struct fields, or slice/array/map shape."""

    __slots__ = ("kind", "name", "fields", "elem", "key", "length")

    def __init__(self, kind: str, name: str = "", fields=None, elem=0,
                 key=0, length=0):
        self.kind = kind  # "struct" | "slice" | "array" | "map"
        self.name = name
        self.fields = fields or []  # [(name, type_id)]
        self.elem = elem
        self.key = key
        self.length = length


def _bootstrap_types() -> dict[int, _WType]:
    s = _WType
    return {
        T_COMMONTYPE: s("struct", "CommonType",
                        [("Name", T_STRING), ("Id", T_INT)]),
        T_ARRAYTYPE: s("struct", "ArrayType",
                       [("CommonType", T_COMMONTYPE), ("Elem", T_INT),
                        ("Len", T_INT)]),
        T_SLICETYPE: s("struct", "SliceType",
                       [("CommonType", T_COMMONTYPE), ("Elem", T_INT)]),
        T_STRUCTTYPE: s("struct", "StructType",
                        [("CommonType", T_COMMONTYPE),
                         ("Field", T_FIELDSLICE)]),
        T_FIELDTYPE: s("struct", "FieldType",
                       [("Name", T_STRING), ("Id", T_INT)]),
        T_FIELDSLICE: s("slice", "[]FieldType", elem=T_FIELDTYPE),
        T_MAPTYPE: s("struct", "MapType",
                     [("CommonType", T_COMMONTYPE), ("Key", T_INT),
                      ("Elem", T_INT)]),
        T_GOBENCODER: s("struct", "gobEncoderType",
                        [("CommonType", T_COMMONTYPE)]),
        T_BINMARSHALER: s("struct", "binaryMarshalerType",
                          [("CommonType", T_COMMONTYPE)]),
        T_TEXTMARSHALER: s("struct", "textMarshalerType",
                           [("CommonType", T_COMMONTYPE)]),
        T_WIRETYPE: s("struct", "wireType",
                      [("ArrayT", T_ARRAYTYPE), ("SliceT", T_SLICETYPE),
                       ("StructT", T_STRUCTTYPE), ("MapT", T_MAPTYPE),
                       ("GobEncoderT", T_GOBENCODER),
                       ("BinaryMarshalerT", T_BINMARSHALER),
                       ("TextMarshalerT", T_TEXTMARSHALER)]),
    }


# ---------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------
class GobStreamDecoder:
    """Incremental decoder: ``feed(data)`` returns the list of complete
    top-level values decoded so far (structs become dicts of the fields
    present on the wire — gob omits zero-valued fields, so consumers use
    ``.get(name, default)``)."""

    def __init__(self) -> None:
        self._buf = b""
        self._types = _bootstrap_types()

    # Go's gob caps messages at 1GB; anything larger in the length
    # prefix means a desynced/corrupt stream, not a big message.
    MAX_MESSAGE = 1 << 30

    def _try_length(self) -> int | None:
        """Parse the message length prefix: None = genuinely incomplete
        (wait for more bytes); GobError = corrupt (count byte out of
        range, or absurd length) — the stream cannot resynchronize."""
        if not self._buf:
            return None
        b = self._buf[0]
        if b < 0x80:
            return b
        n = 256 - b
        if n > 8:
            raise GobError(f"gob: length prefix byte count {n} > 8")
        if len(self._buf) < 1 + n:
            return None
        v = int.from_bytes(self._buf[1 : 1 + n], "big")
        if v > self.MAX_MESSAGE:
            raise GobError(f"gob: message length {v} exceeds 1GB cap")
        return v

    # -- message framing ----------------------------------------------
    def feed(self, data: bytes) -> list[Any]:
        """Returns complete top-level values decoded so far. Raises
        GobError on a CORRUPT stream (vs merely truncated) — gob framing
        is stateful, so the caller must drop the connection; treating
        corruption as 'incomplete' would stall forever while the buffer
        grows unboundedly."""
        self._buf += data
        out: list[Any] = []
        while True:
            msg_len = self._try_length()
            if msg_len is None:
                break  # incomplete length prefix
            r = _Reader(self._buf)
            r.uint()  # consume the validated prefix
            if len(self._buf) - r.pos < msg_len:
                break  # incomplete message body
            body = _Reader(self._buf[r.pos : r.pos + msg_len])
            self._buf = self._buf[r.pos + msg_len :]
            val = self._message(body)
            if val is not None:
                out.append(val[0])
        return out

    def _message(self, r: _Reader):
        type_id = r.int_()
        if type_id < 0:
            self._register(-type_id, self._decode_value(T_WIRETYPE, r))
            return None
        wt = self._types.get(type_id)
        if wt is None or wt.kind != "struct":
            delta = r.uint()  # singleton values carry one zero delta
            if delta != 0:
                raise GobError(f"gob: bad singleton delta {delta}")
        return (self._decode_value(type_id, r),)

    def _register(self, type_id: int, wire: Any) -> None:
        if not isinstance(wire, dict):
            raise GobError("gob: malformed type descriptor")
        if "StructT" in wire:
            st = wire["StructT"]
            common = st.get("CommonType", {})
            fields = [
                (f.get("Name", ""), f.get("Id", 0))
                for f in st.get("Field", [])
            ]
            self._types[type_id] = _WType(
                "struct", common.get("Name", ""), fields
            )
        elif "SliceT" in wire:
            st = wire["SliceT"]
            self._types[type_id] = _WType(
                "slice", elem=st.get("Elem", 0)
            )
        elif "ArrayT" in wire:
            st = wire["ArrayT"]
            self._types[type_id] = _WType(
                "array", elem=st.get("Elem", 0),
                length=st.get("Len", 0),
            )
        elif "MapT" in wire:
            st = wire["MapT"]
            self._types[type_id] = _WType(
                "map", key=st.get("Key", 0), elem=st.get("Elem", 0)
            )
        else:
            raise GobError(
                f"gob: unsupported type descriptor {sorted(wire)}"
            )

    # -- values --------------------------------------------------------
    def _decode_value(self, type_id: int, r: _Reader) -> Any:
        if type_id == T_BOOL:
            return r.uint() != 0
        if type_id == T_INT:
            return r.int_()
        if type_id == T_UINT:
            return r.uint()
        if type_id == T_FLOAT:
            return _float_from_uint(r.uint())
        if type_id == T_BYTES:
            return r.take(r.uint())
        if type_id == T_STRING:
            return r.take(r.uint()).decode("utf-8", "replace")
        if type_id == T_COMPLEX:
            return complex(
                _float_from_uint(r.uint()), _float_from_uint(r.uint())
            )
        wt = self._types.get(type_id)
        if wt is None:
            raise GobError(f"gob: unknown type id {type_id}")
        if wt.kind == "struct":
            out: dict[str, Any] = {}
            field = -1
            while True:
                delta = r.uint()
                if delta == 0:
                    return out
                field += delta
                if field >= len(wt.fields):
                    raise GobError(
                        f"gob: field {field} out of range for "
                        f"{wt.name or type_id}"
                    )
                name, ftype = wt.fields[field]
                out[name] = self._decode_value(ftype, r)
        if wt.kind in ("slice", "array"):
            n = r.uint()
            if wt.kind == "array" and n != wt.length:
                raise GobError("gob: array length mismatch")
            if n > len(r.buf):  # each element is >= 1 byte
                raise GobError("gob: slice count exceeds message size")
            return [self._decode_value(wt.elem, r) for _ in range(n)]
        if wt.kind == "map":
            n = r.uint()
            if n > len(r.buf) // 2:
                raise GobError("gob: map count exceeds message size")
            return {
                self._decode_value(wt.key, r): self._decode_value(
                    wt.elem, r
                )
                for _ in range(n)
            }
        raise GobError(f"gob: unhandled kind {wt.kind}")


# ---------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------
class GobStructEncoder:
    """Encoder for ONE struct type (the ``gob.NewEncoder`` analog for a
    homogeneous stream, which is exactly what the monitor socket is).

    ``fields`` is the Go-declaration-ordered list of (name, type_id)
    with type ids from the bootstrap basics (T_BYTES/T_INT/T_UINT/...).
    The first :meth:`encode` emits the type-descriptor message, like Go.
    """

    def __init__(self, name: str, fields: list[tuple[str, int]],
                 type_id: int = FIRST_USER_ID):
        self.name = name
        self.fields = fields
        self.type_id = type_id
        self._sent_types = False

    def _type_descriptor(self) -> bytes:
        w = _Writer()
        w.int_(-self.type_id)
        # wireType struct, field 2 = StructT
        w.uint(3)
        # StructType field 0: CommonType{Name, Id}
        w.uint(1)
        w.uint(1)
        nm = self.name.encode()
        w.uint(len(nm))
        w.bytes_(nm)
        w.uint(1)
        w.int_(self.type_id)
        w.uint(0)  # end CommonType
        # StructType field 1: Field []fieldType
        w.uint(1)
        w.uint(len(self.fields))
        for fname, ftid in self.fields:
            w.uint(1)
            fn = fname.encode()
            w.uint(len(fn))
            w.bytes_(fn)
            w.uint(1)
            w.int_(ftid)
            w.uint(0)
        w.uint(0)  # end StructType
        w.uint(0)  # end wireType
        return w.getvalue()

    @staticmethod
    def _frame(body: bytes) -> bytes:
        w = _Writer()
        w.uint(len(body))
        return w.getvalue() + body

    def encode(self, value: dict[str, Any]) -> bytes:
        """Encode one struct value (zero-valued fields omitted, per
        gob), prefixed by the type descriptor on the first call."""
        out = b""
        if not self._sent_types:
            out += self._frame(self._type_descriptor())
            self._sent_types = True
        w = _Writer()
        w.int_(self.type_id)
        prev = -1
        for i, (fname, ftid) in enumerate(self.fields):
            v = value.get(fname)
            if not v:  # gob omits zero values
                continue
            w.uint(i - prev)
            prev = i
            if ftid == T_BOOL:
                w.uint(1)
            elif ftid == T_INT:
                w.int_(int(v))
            elif ftid == T_UINT:
                w.uint(int(v))
            elif ftid == T_FLOAT:
                w.float_(float(v))
            elif ftid == T_BYTES:
                w.uint(len(v))
                w.bytes_(bytes(v))
            elif ftid == T_STRING:
                b = str(v).encode()
                w.uint(len(b))
                w.bytes_(b)
            else:
                raise GobError(f"encoder: unsupported field type {ftid}")
        w.uint(0)
        return out + self._frame(w.getvalue())
