"""Strict XML ingestion for OpenPSA-MEF input files.

Capability parity with the reference XML IO layer
(``/root/reference/src/io/xml/{document,element,range,validator,helpers}.h``):

* :class:`Document` — parse a file with XInclude resolution, no network
  access, and optional RELAX NG validation (``document.h:15-33``).
* :class:`Element` — immutable adaptor over a DOM node with trimmed,
  *strictly typed* attribute/text access and name-filtered child iteration
  (``element.h:18-96``); every element knows its ``filename``/``line`` so
  model errors always carry source context.
* :class:`Validator` — compiled RELAX NG schema (``validator.h:12-20``).

Parsing uses the standard library only (expat through
``xml.etree.ElementTree``), so loading and analysing a model needs no
third-party XML package. The standard library has no RELAX NG engine:
:class:`Validator` imports ``lxml`` when a schema is asked for, and says
so when it is missing.
"""

from __future__ import annotations

import os
import re
import urllib.parse
import xml.etree.ElementInclude as ElementInclude
import xml.etree.ElementTree as ET
from typing import Iterator
from xml.parsers import expat

from ..errors import (IllegalOperation, XIncludeError, XmlParseError,
                      XmlValidityError)

__all__ = ["Document", "Element", "Validator", "to_bool", "to_int", "to_float"]

_TRUE = {"true", "1"}
_FALSE = {"false", "0"}

# Strict number grammars: reject partial parses like "1.5x" or "" that
# Python's int()/float() plus stripping could otherwise let through oddly.
_INT_RE = re.compile(r"^[+-]?\d+$")
_FLOAT_RE = re.compile(
    r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")

#: Nested XInclude depth limit (include loops are rejected separately).
_MAX_INCLUDE_DEPTH = 32


def to_bool(text: str) -> bool:
    """Strict xs:boolean parse ('true'/'false'/'1'/'0')."""
    text = text.strip()
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    raise ValueError(f"Failed to interpret value '{text}' as boolean.")


def to_int(text: str) -> int:
    """Strict integer parse (whole-string match only)."""
    text = text.strip()
    if not _INT_RE.match(text):
        raise ValueError(f"Failed to interpret value '{text}' as int.")
    return int(text)


def to_float(text: str) -> float:
    """Strict floating-point parse (whole-string match only)."""
    text = text.strip()
    if not _FLOAT_RE.match(text):
        raise ValueError(f"Failed to interpret value '{text}' as float.")
    return float(text)


_CONVERTERS = {bool: to_bool, int: to_int, float: to_float, str: lambda s: s.strip()}


class _SourceElement(ET.Element):
    """An ElementTree node that remembers its source file and line."""

    sourceline = 0
    filename = "<memory>"

    def __copy__(self):
        # ElementInclude copies every included root; keep the subclass
        # and its source position (the C base class would drop both).
        node = _SourceElement(self.tag, self.attrib)
        node.text, node.tail = self.text, self.tail
        node[:] = list(self)
        node.__dict__.update(self.__dict__)
        return node


def _qualified(name: str) -> str:
    """expat's ``uri}local`` (namespace_separator="}") -> ``{uri}local``."""
    return "{" + name if "}" in name else name


def _parse(data: bytes, filename: str) -> _SourceElement:
    """Parse ``data`` into a tree of :class:`_SourceElement` nodes.

    Entity declarations are refused (no entity expansion, internal or
    external) and nothing is fetched: the posture of the reference's
    parser, which disables network access.
    """
    builder = ET.TreeBuilder(element_factory=_SourceElement)
    parser = expat.ParserCreate(namespace_separator="}")
    parser.SetParamEntityParsing(expat.XML_PARAM_ENTITY_PARSING_NEVER)
    parser.buffer_text = True

    def start(tag, attrs):
        node = builder.start(_qualified(tag),
                             {_qualified(k): v for k, v in attrs.items()})
        node.sourceline = parser.CurrentLineNumber
        node.filename = filename

    def refuse_entity(name, *_args):
        raise XmlParseError(f"Entity declarations are not allowed "
                            f"('{name}').", filename=filename,
                            line=parser.CurrentLineNumber)

    parser.StartElementHandler = start
    parser.EndElementHandler = lambda tag: builder.end(_qualified(tag))
    parser.CharacterDataHandler = builder.data
    parser.EntityDeclHandler = refuse_entity
    parser.UnparsedEntityDeclHandler = refuse_entity
    try:
        parser.Parse(data, True)
    except expat.ExpatError as exc:
        raise XmlParseError(str(exc), filename=filename,
                            line=exc.lineno) from exc
    return builder.close()


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _local_loader(href: str, parse: str, encoding: str | None = None):
    """XInclude loader for local files only (no network, no URL schemes)."""
    url = urllib.parse.urlparse(href)
    if url.scheme not in ("", "file") and not os.path.isabs(href):
        raise OSError(f"non-local XInclude href refused: {href}")
    path = url.path if url.scheme == "file" else href
    data = _read(path)
    if parse == "xml":
        return _parse(data, path)
    return data.decode(encoding or "utf-8")


def _resolve_includes(root: _SourceElement, filename: str,
                      base_url: str | None) -> _SourceElement:
    try:
        # The root itself may be an include; wrap it so it can be replaced.
        holder = ET.Element("holder")
        holder.append(root)
        ElementInclude.include(holder, loader=_local_loader,
                               base_url=base_url,
                               max_depth=_MAX_INCLUDE_DEPTH)
        return holder[0]
    except (ElementInclude.FatalIncludeError, OSError, XmlParseError) as exc:
        raise XIncludeError(str(exc), filename=filename) from exc


class Element:
    """Immutable adaptor over an XML element node.

    Mirrors the access surface of the reference ``io::xml::element``:
    ``name``, ``filename``, ``line``, ``has_attribute``, ``attribute``
    (trimmed, optionally typed), ``text`` (typed), ``child``, ``children``
    (optionally name-filtered).
    """

    __slots__ = ("_node",)

    def __init__(self, node):
        self._node = node

    # -- identity ----------------------------------------------------------
    @property
    def name(self) -> str:
        return self._node.tag.rpartition("}")[2]

    @property
    def filename(self) -> str:
        return getattr(self._node, "filename", "<memory>")

    @property
    def line(self) -> int:
        return getattr(self._node, "sourceline", 0)

    # -- attributes --------------------------------------------------------
    def has_attribute(self, name: str) -> bool:
        return name in self._node.attrib

    def attribute(self, name: str, type_=str, default=None):
        """Typed, trimmed attribute access.

        Returns ``default`` when the attribute is missing. Raises
        :class:`XmlValidityError` (with file:line) on a failed typed parse.
        """
        raw = self._node.get(name)
        if raw is None:
            return default
        try:
            return _CONVERTERS[type_](raw)
        except ValueError as exc:
            raise XmlValidityError(str(exc), filename=self.filename,
                                   line=self.line) from exc

    # -- text --------------------------------------------------------------
    def text(self, type_=str):
        raw = self._node.text or ""
        try:
            return _CONVERTERS[type_](raw)
        except ValueError as exc:
            raise XmlValidityError(str(exc), filename=self.filename,
                                   line=self.line) from exc

    # -- children ----------------------------------------------------------
    def child(self, name: str | None = None) -> "Element | None":
        """The first child element (optionally restricted by name)."""
        return next(iter(self.children(name)), None)

    def children(self, name: str | None = None) -> Iterator["Element"]:
        """Iterate child elements in document order.

        Matches the reference ``range`` view semantics
        (``src/io/xml/range.h:11-69``): document order, elements only,
        optional name filter.
        """
        for node in self._node:
            if name is None or node.tag.rpartition("}")[2] == name:
                yield Element(node)

    def num_children(self, name: str | None = None) -> int:
        return sum(1 for _ in self.children(name))

    def __repr__(self) -> str:  # pragma: no cover
        return f"<Element {self.name} at {self.filename}:{self.line}>"


class Validator:
    """Compiled RELAX NG schema validator (reference ``validator.h:12-20``).

    The standard library has no RELAX NG engine, so this is the one part
    of the XML layer that needs ``lxml``; it is imported here, only when
    a schema is asked for (``--validate`` or a project file).
    """

    def __init__(self, schema_path: str):
        try:
            from lxml import etree
        except ImportError as exc:
            raise IllegalOperation(
                "RELAX NG validation needs the 'lxml' package, which is "
                "not installed (pip install 'canopy-tpu[validation]').",
                filename=schema_path) from exc
        self._etree = etree
        try:
            self._schema = etree.RelaxNG(etree.parse(schema_path))
        except (etree.XMLSyntaxError, etree.RelaxNGError) as exc:
            raise XmlParseError(f"Invalid RELAX NG schema: {exc}",
                                filename=schema_path) from exc

    def validate(self, document: "Document") -> None:
        etree = self._etree
        parser = etree.XMLParser(huge_tree=True, no_network=True,
                                 resolve_entities=False)
        if document._path is not None:
            tree = etree.parse(document._path, parser)
        else:
            tree = etree.fromstring(document._text, parser).getroottree()
        tree.xinclude()
        if not self._schema.validate(tree):
            err = self._schema.error_log.last_error
            raise XmlValidityError(
                err.message if err else "Document failed RELAX NG validation.",
                filename=document.filename,
                line=err.line if err else None)


class Document:
    """A parsed MEF input file: XInclude-resolved, optionally validated.

    Parser posture matches the reference (``document.cpp:8-35``): XInclude
    resolution from local files, *no network access*, with entity
    declarations refused (hardening beyond the reference).
    """

    def __init__(self, file_path: str, validator: Validator | None = None):
        try:
            data = _read(file_path)
        except OSError as exc:
            raise XmlParseError(f"Cannot read input file: {exc}",
                                filename=file_path) from exc
        self._init(data, file_path, file_path, None, validator)

    @classmethod
    def from_string(cls, text: str, filename: str = "<memory>",
                    validator: Validator | None = None) -> "Document":
        """Parse from an in-memory string (used heavily by tests)."""
        self = cls.__new__(cls)
        self._init(text.encode(), filename, None, text.encode(), validator)
        return self

    def _init(self, data: bytes, filename: str, path: str | None,
              text: bytes | None, validator: Validator | None) -> None:
        self._filename = filename
        self._path = path
        self._text = text
        root = _parse(data, filename)
        self._root = _resolve_includes(root, filename, path)
        if validator is not None:
            validator.validate(self)

    @property
    def filename(self) -> str:
        return self._filename

    @property
    def root(self) -> Element:
        return Element(self._root)
