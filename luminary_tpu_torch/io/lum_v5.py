""".lum v5 — a small scene-scripting language.

The reference ships a v5 pipeline (host/lum/: tokenizer 393 LoC → compiler
1142 LoC → 64-bit instruction encoding NOP/REGMAP/MOV/CALL/RET/CVT → register
VM with 256 registers + per-entity builtin function/member tables,
lum_instruction.h:7-15, lum_virtual_machine.h:7-13) whose execution stage is
unfinished: it compiles and prints but never applies to content
(lum_v5.c:42-43 TODO). This module implements the same architecture —
tokenizer → compiler → fixed-width instruction stream → register VM — with a
complete execution stage that builds a LumFileContent.

Language (documented here since the reference defines none publicly)::

    Luminary
    VERSION 5

    settings s = settings.init();
    s.width = 1920;
    s.height = 540 * 2;

    camera c = camera.init();
    c.pos = vec3(0.0, 1.0, 3.5);
    c.fov = 0.35;

    mesh m = mesh.load("Example.obj");
    instance i = instance.init(m);
    i.position = vec3(0, 0, -1);

    sky k = sky.init();
    k.mode = SKY_MODE_CONSTANT_COLOR;   # enum literals resolve by name

Statements: declarations ``<type> <name> = <expr>;``, member assignments
``<name>.<member> = <expr>;``. Expressions: numbers, strings, identifiers,
enum literals, ``vec3(x, y, z)``, ``rgb(r, g, b)``, binary ``+ - * /``,
unary ``-``, parentheses, ``<type>.<func>(args)`` builtin calls.

Instruction encoding (64-bit words, reference-style fixed width)::

    bits  0..7   opcode
    bits  8..15  dst register
    bits 16..23  src0 register
    bits 24..31  src1 register
    bits 32..63  imm32 (constant-pool id / builtin id / src2)

A host copy of ``luminary_tpu/io/lum_v5.py``: the port keeps its own so that
it imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

from ..scene.entities import (
    ApertureShape,
    Filter,
    Instance,
    JerlovWaterType,
    MaterialBaseSubstrate,
    ShadingMode,
    SkyMode,
    ToneMap,
)
from ..utils.errors import FileIOError

NUM_REGISTERS = 256  # reference: lum_virtual_machine.h 256 registers


class Op(IntEnum):
    NOP = 0
    LOADC = 1  # dst <- const_pool[imm]
    MOV = 2  # dst <- src0
    ADD = 3
    SUB = 4
    MUL = 5
    DIV = 6
    NEG = 7
    VEC3 = 8  # dst <- (src0, src1, reg[imm])
    CALL = 9  # dst <- builtin[imm](src0...)  src1 = argc
    SETM = 10  # object src0 . member[imm] <- src1
    RET = 11
    CVT = 12  # dst <- float(src0)  (reference opcode parity)


def encode(op: Op, dst: int = 0, src0: int = 0, src1: int = 0, imm: int = 0) -> int:
    return (
        (int(op) & 0xFF)
        | ((dst & 0xFF) << 8)
        | ((src0 & 0xFF) << 16)
        | ((src1 & 0xFF) << 24)
        | ((imm & 0xFFFFFFFF) << 32)
    )


def decode(word: int):
    return (
        Op(word & 0xFF),
        (word >> 8) & 0xFF,
        (word >> 16) & 0xFF,
        (word >> 24) & 0xFF,
        (word >> 32) & 0xFFFFFFFF,
    )


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------


@dataclass
class Token:
    kind: str  # ident | number | string | op | sep
    text: str
    line: int


_SEPARATORS = set("(),;.{}")
_OPERATORS = set("+-*/=")


def tokenize(code: str) -> list[Token]:
    tokens: list[Token] = []
    i, line = 0, 1
    n = len(code)
    while i < n:
        c = code[i]
        if c == "\n":
            line += 1
            i += 1
        elif c in " \t\r":
            i += 1
        elif c == "#" or code.startswith("//", i):
            while i < n and code[i] != "\n":
                i += 1
        elif c == '"':
            j = i + 1
            while j < n and code[j] != '"':
                if code[j] == "\n":
                    raise FileIOError(f"lum v5: unterminated string at line {line}")
                j += 1
            if j >= n:
                raise FileIOError(f"lum v5: unterminated string at line {line}")
            tokens.append(Token("string", code[i + 1 : j], line))
            i = j + 1
        elif c.isdigit() or (c == "." and i + 1 < n and code[i + 1].isdigit()):
            j = i
            while j < n and (code[j].isdigit() or code[j] in ".eE" or
                             (code[j] in "+-" and code[j - 1] in "eE")):
                j += 1
            tokens.append(Token("number", code[i:j], line))
            i = j
        elif c.isalpha() or c == "_":
            j = i
            while j < n and (code[j].isalnum() or code[j] == "_"):
                j += 1
            tokens.append(Token("ident", code[i:j], line))
            i = j
        elif c in _OPERATORS:
            tokens.append(Token("op", c, line))
            i += 1
        elif c in _SEPARATORS:
            tokens.append(Token("sep", c, line))
            i += 1
        else:
            raise FileIOError(f"lum v5: unexpected character {c!r} at line {line}")
    return tokens


# ---------------------------------------------------------------------------
# Builtin tables (reference: lum_function_tables.c, lum_builtins.c)
# ---------------------------------------------------------------------------

ENTITY_TYPES = (
    "settings", "camera", "ocean", "sky", "cloud", "fog", "particles",
    "material", "instance", "mesh", "metadata",
)

# enum literals by UPPER_SNAKE name (reference: lum_builtin_enums)
_ENUMS: dict[str, int] = {}
for _enum, _prefix in (
    (ShadingMode, "SHADING_MODE_"),
    (Filter, "FILTER_"),
    (ToneMap, "TONEMAP_"),
    (ApertureShape, "APERTURE_"),
    (JerlovWaterType, "JERLOV_WATER_TYPE_"),
    (SkyMode, "SKY_MODE_"),
    (MaterialBaseSubstrate, "MATERIAL_BASE_SUBSTRATE_"),
):
    for _m in _enum:
        _ENUMS[_prefix + _m.name] = int(_m)

# builtin functions: id → (entity_type, func_name)
BUILTINS: list[tuple[str, str]] = []
_BUILTIN_ID: dict[tuple[str, str], int] = {}
for _t in ENTITY_TYPES:
    for _f in ("init",):
        _BUILTIN_ID[(_t, _f)] = len(BUILTINS)
        BUILTINS.append((_t, _f))
_BUILTIN_ID[("mesh", "load")] = len(BUILTINS)
BUILTINS.append(("mesh", "load"))

# member ids: stable global table of (entity_type, member) pairs
MEMBERS: list[tuple[str, str]] = []
_MEMBER_ID: dict[tuple[str, str], int] = {}


def _member_id(entity_type: str, member: str) -> int:
    key = (entity_type, member)
    if key not in _MEMBER_ID:
        _MEMBER_ID[key] = len(MEMBERS)
        MEMBERS.append(key)
    return _MEMBER_ID[key]


# ---------------------------------------------------------------------------
# Compiler
# ---------------------------------------------------------------------------


@dataclass
class LumBinary:
    """Compiled program (reference: lum_binary.h)."""

    instructions: list[int] = field(default_factory=list)
    const_pool: list[object] = field(default_factory=list)

    def disassemble(self) -> str:
        out = []
        for w in self.instructions:
            op, dst, s0, s1, imm = decode(w)
            out.append(f"{op.name:6s} r{dst:<3d} r{s0:<3d} r{s1:<3d} #{imm}")
        return "\n".join(out)


class _Compiler:
    def __init__(self, tokens: list[Token]):
        self.toks = tokens
        self.pos = 0
        self.binary = LumBinary()
        self.next_reg = 1  # r0 is the zero/void register
        self.vars: dict[str, tuple[str, int]] = {}  # name → (type, register)

    # -- token helpers --
    def peek(self, k=0) -> Token | None:
        return self.toks[self.pos + k] if self.pos + k < len(self.toks) else None

    def next(self) -> Token:
        t = self.peek()
        if t is None:
            raise FileIOError("lum v5: unexpected end of file")
        self.pos += 1
        return t

    def expect(self, kind: str, text: str | None = None) -> Token:
        t = self.next()
        if t.kind != kind or (text is not None and t.text != text):
            raise FileIOError(
                f"lum v5: expected {text or kind} at line {t.line}, got {t.text!r}"
            )
        return t

    def alloc(self) -> int:
        if self.next_reg >= NUM_REGISTERS:
            raise FileIOError("lum v5: out of registers (program too large)")
        r = self.next_reg
        self.next_reg += 1
        return r

    def emit(self, *args, **kw):
        self.binary.instructions.append(encode(*args, **kw))

    def const(self, value) -> int:
        self.binary.const_pool.append(value)
        return len(self.binary.const_pool) - 1

    # -- grammar --
    def compile(self) -> LumBinary:
        while self.peek() is not None:
            self.statement()
        self.emit(Op.RET)
        return self.binary

    def statement(self):
        t = self.peek()
        nxt = self.peek(1)
        if (
            t.kind == "ident" and t.text in ENTITY_TYPES
            and nxt is not None and nxt.kind == "ident"
        ):
            self.declaration()
        elif t.kind == "ident":
            self.assignment()
        else:
            raise FileIOError(f"lum v5: unexpected token {t.text!r} at line {t.line}")

    def declaration(self):
        type_tok = self.next()
        name = self.expect("ident").text
        self.expect("op", "=")
        _vt, reg = self.expression()
        self.expect("sep", ";")
        self.vars[name] = (type_tok.text, reg)

    def assignment(self):
        name = self.expect("ident").text
        if name not in self.vars:
            raise FileIOError(f"lum v5: undeclared variable {name!r}")
        vtype, vreg = self.vars[name]
        self.expect("sep", ".")
        member = self.expect("ident").text
        self.expect("op", "=")
        _vt, src = self.expression()
        self.expect("sep", ";")
        self.emit(Op.SETM, 0, vreg, src, imm=_member_id(vtype, member))

    # expression → term (('+'|'-') term)*
    def expression(self) -> tuple[str, int]:
        vt, reg = self.term()
        while (t := self.peek()) is not None and t.kind == "op" and t.text in "+-":
            self.next()
            _vt2, rhs = self.term()
            dst = self.alloc()
            self.emit(Op.ADD if t.text == "+" else Op.SUB, dst, reg, rhs)
            vt, reg = "float", dst
        return vt, reg

    def term(self) -> tuple[str, int]:
        vt, reg = self.unary()
        while (t := self.peek()) is not None and t.kind == "op" and t.text in "*/":
            self.next()
            _vt2, rhs = self.unary()
            dst = self.alloc()
            self.emit(Op.MUL if t.text == "*" else Op.DIV, dst, reg, rhs)
            vt, reg = "float", dst
        return vt, reg

    def unary(self) -> tuple[str, int]:
        t = self.peek()
        if t.kind == "op" and t.text == "-":
            self.next()
            _vt, reg = self.unary()
            dst = self.alloc()
            self.emit(Op.NEG, dst, reg)
            return "float", dst
        return self.primary()

    def primary(self) -> tuple[str, int]:
        t = self.next()
        if t.kind == "number":
            dst = self.alloc()
            self.emit(Op.LOADC, dst, imm=self.const(float(t.text)))
            return "float", dst
        if t.kind == "string":
            dst = self.alloc()
            self.emit(Op.LOADC, dst, imm=self.const(t.text))
            return "string", dst
        if t.kind == "sep" and t.text == "(":
            vt, reg = self.expression()
            self.expect("sep", ")")
            return vt, reg
        if t.kind == "ident":
            # vec3(...) / rgb(...)
            if t.text in ("vec3", "rgb") and self._at("sep", "("):
                self.next()
                _a, ra = self.expression()
                self.expect("sep", ",")
                _b, rb = self.expression()
                self.expect("sep", ",")
                _c, rc = self.expression()
                self.expect("sep", ")")
                dst = self.alloc()
                self.emit(Op.VEC3, dst, ra, rb, imm=rc)
                return "vec3", dst
            # entity_type.func(args)
            if t.text in ENTITY_TYPES and self._at("sep", "."):
                self.next()
                fname = self.expect("ident").text
                self.expect("sep", "(")
                args = []
                if not self._at("sep", ")"):
                    while True:
                        _vt, r = self.expression()
                        args.append(r)
                        if self._at("sep", ","):
                            self.next()
                            continue
                        break
                self.expect("sep", ")")
                key = (t.text, fname)
                if key not in _BUILTIN_ID:
                    raise FileIOError(
                        f"lum v5: unknown builtin {t.text}.{fname} at line {t.line}"
                    )
                dst = self.alloc()
                src0 = args[0] if args else 0
                self.emit(Op.CALL, dst, src0, len(args), imm=_BUILTIN_ID[key])
                return t.text, dst
            # enum literal
            if t.text in _ENUMS:
                dst = self.alloc()
                self.emit(Op.LOADC, dst, imm=self.const(float(_ENUMS[t.text])))
                return "float", dst
            # variable reference
            if t.text in self.vars:
                vt, reg = self.vars[t.text]
                return vt, reg
            raise FileIOError(f"lum v5: unknown identifier {t.text!r} at line {t.line}")
        raise FileIOError(f"lum v5: unexpected token {t.text!r} at line {t.line}")

    def _at(self, kind: str, text: str) -> bool:
        t = self.peek()
        return t is not None and t.kind == kind and t.text == text


def compile_lum_v5(code: str) -> LumBinary:
    return _Compiler(tokenize(code)).compile()


# ---------------------------------------------------------------------------
# Virtual machine (reference: lum_virtual_machine.c — here with a complete
# execution stage that applies to content)
# ---------------------------------------------------------------------------


class LumVM:
    def __init__(self, content):
        self.content = content
        self.regs: list[object] = [None] * NUM_REGISTERS
        self._materials: list[object] = []

    def _entity(self, name: str):
        if name == "metadata":
            return self.content
        return getattr(self.content, name, None)

    def run(self, binary: LumBinary):
        content = self.content
        for word in binary.instructions:
            op, dst, s0, s1, imm = decode(word)
            r = self.regs
            if op == Op.NOP:
                continue
            if op == Op.RET:
                break
            if op == Op.LOADC:
                r[dst] = binary.const_pool[imm]
            elif op == Op.MOV:
                r[dst] = r[s0]
            elif op in (Op.ADD, Op.SUB, Op.MUL, Op.DIV):
                a, b = float(r[s0]), float(r[s1])
                if op == Op.ADD:
                    r[dst] = a + b
                elif op == Op.SUB:
                    r[dst] = a - b
                elif op == Op.MUL:
                    r[dst] = a * b
                else:
                    r[dst] = a / b if b != 0.0 else 0.0
            elif op == Op.NEG:
                r[dst] = -float(r[s0])
            elif op == Op.CVT:
                r[dst] = float(r[s0])
            elif op == Op.VEC3:
                r[dst] = (float(r[s0]), float(r[s1]), float(r[imm]))
            elif op == Op.CALL:
                etype, fname = BUILTINS[imm]
                if fname == "init":
                    if etype == "instance":
                        inst = Instance(id=len(content.instances))
                        if s1 >= 1:
                            inst.mesh_id = int(r[s0])
                        content.instances.append(inst)
                        r[dst] = inst
                    elif etype == "material":
                        from ..scene.entities import Material

                        mat = Material(id=len(self._materials))
                        self._materials.append(mat)
                        r[dst] = mat
                    elif etype == "mesh":
                        r[dst] = len(content.obj_file_paths)
                    else:
                        r[dst] = self._entity(etype)
                elif (etype, fname) == ("mesh", "load"):
                    content.obj_file_paths.append(str(r[s0]))
                    r[dst] = len(content.obj_file_paths) - 1
                else:
                    raise FileIOError(f"lum v5: unimplemented builtin {etype}.{fname}")
            elif op == Op.SETM:
                etype, member = MEMBERS[imm]
                obj = self.regs[s0]
                value = self.regs[s1]
                if obj is None:
                    raise FileIOError("lum v5: member set on void object")
                if etype == "mesh":
                    raise FileIOError("lum v5: mesh has no settable members")
                if not hasattr(obj, member):
                    raise FileIOError(
                        f"lum v5: {etype} has no member {member!r}"
                    )
                cur = getattr(obj, member)
                if isinstance(cur, bool):
                    value = bool(value)
                elif isinstance(cur, int) and not isinstance(value, tuple):
                    value = int(float(value))
                elif isinstance(cur, float):
                    value = float(value)
                setattr(obj, member, value)
        return content


def parse_lum_v5(text: str, base_dir: str = ".") -> "LumFileContent":
    """Compile + execute a v5 script into a LumFileContent."""
    from .lum import LumFileContent

    # strip header lines (Luminary / VERSION 5)
    lines = text.splitlines()
    body = []
    for ln in lines:
        stripped = ln.strip()
        if stripped == "Luminary" or stripped.startswith("VERSION"):
            continue
        body.append(ln)
    binary = compile_lum_v5("\n".join(body))
    content = LumFileContent()
    LumVM(content).run(binary)
    return content
