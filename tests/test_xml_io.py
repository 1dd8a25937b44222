"""XML IO layer tests (strict typed parsing, file:line context)."""

import pytest

from canopy_tpu.errors import XIncludeError, XmlParseError, XmlValidityError
from canopy_tpu.io.xml import Document, to_bool, to_float, to_int


class TestTypedParsing:
    def test_bool(self):
        assert to_bool("true") is True
        assert to_bool(" 1 ") is True
        assert to_bool("false") is False
        assert to_bool("0") is False
        with pytest.raises(ValueError):
            to_bool("yes")

    def test_int_strict(self):
        assert to_int("42") == 42
        assert to_int(" -7 ") == -7
        for bad in ("1.5", "4x", "", "0x10"):
            with pytest.raises(ValueError):
                to_int(bad)

    def test_float_strict(self):
        assert to_float("1.5e-3") == 1.5e-3
        assert to_float(".5") == 0.5
        for bad in ("1.5x", "", "nan-ish"):
            with pytest.raises(ValueError):
                to_float(bad)


class TestDocument:
    def test_parse_and_navigate(self):
        doc = Document.from_string(
            "<root><a x=' 3 '/><b>text</b><!-- comment --><a x='4'/></root>")
        root = doc.root
        assert root.name == "root"
        assert [c.name for c in root.children()] == ["a", "b", "a"]
        assert [c.name for c in root.children("a")] == ["a", "a"]
        assert root.child("b").text() == "text"
        assert root.child("a").attribute("x", int) == 3

    def test_malformed_raises(self):
        with pytest.raises(XmlParseError):
            Document.from_string("<root><unclosed></root>")

    def test_bad_typed_attribute_carries_line(self):
        doc = Document.from_string("<root>\n<a x='notanint'/></root>")
        with pytest.raises(XmlValidityError) as err:
            doc.root.child("a").attribute("x", int)
        assert err.value.line == 2

    def test_missing_attribute_default(self):
        doc = Document.from_string("<root/>")
        assert doc.root.attribute("nope") is None
        assert doc.root.attribute("nope", int, 7) == 7

    def test_line_numbers(self):
        doc = Document.from_string("<root>\n  <child/>\n</root>")
        assert doc.root.child("child").line == 2

    def test_xinclude(self, tmp_path):
        inner = tmp_path / "inner.xml"
        inner.write_text("<inner val='5'/>")
        outer = tmp_path / "outer.xml"
        outer.write_text(
            "<root xmlns:xi='http://www.w3.org/2001/XInclude'>"
            f"<xi:include href='inner.xml'/></root>")
        doc = Document(str(outer))
        assert doc.root.child("inner").attribute("val", int) == 5


class TestStdlibReader:
    """The standard-library reader keeps every error's file and line."""

    def test_nested_line_numbers(self):
        doc = Document.from_string(
            "<root>\n<a>\n\n  <b x='1'/>\n</a>\n<c/></root>")
        a = doc.root.child("a")
        assert (doc.root.line, a.line, a.child("b").line,
                doc.root.child("c").line) == (1, 2, 4, 6)

    def test_file_elements_carry_filename(self, tmp_path):
        path = tmp_path / "m.xml"
        path.write_text("<root>\n<a x='oops'/></root>")
        doc = Document(str(path))
        assert doc.filename == str(path)
        with pytest.raises(XmlValidityError) as err:
            doc.root.child("a").attribute("x", float)
        assert (err.value.filename, err.value.line) == (str(path), 2)

    def test_parse_error_has_line(self):
        with pytest.raises(XmlParseError) as err:
            Document.from_string("<root>\n<a>\n</b></root>",
                                 filename="bad.xml")
        assert err.value.line == 3 and err.value.filename == "bad.xml"

    def test_missing_file(self, tmp_path):
        with pytest.raises(XmlParseError, match="Cannot read"):
            Document(str(tmp_path / "absent.xml"))

    def test_namespaced_names_are_local(self):
        doc = Document.from_string(
            "<m:root xmlns:m='urn:x'><m:a/><b/></m:root>")
        assert doc.root.name == "root"
        assert [c.name for c in doc.root.children()] == ["a", "b"]

    def test_text_and_comments(self):
        doc = Document.from_string(
            "<root><v> 2.5 <!-- note --></v><w>7</w></root>")
        assert doc.root.child("v").text(float) == 2.5
        assert doc.root.child("w").text(int) == 7
        assert doc.root.num_children() == 2

    def test_entity_declarations_refused(self):
        with pytest.raises(XmlParseError, match="Entity"):
            Document.from_string(
                '<?xml version="1.0"?><!DOCTYPE r [<!ENTITY e "boom">]>'
                "<r>&e;</r>")


class TestXInclude:
    def _outer(self, tmp_path, body):
        outer = tmp_path / "outer.xml"
        outer.write_text(
            "<root xmlns:xi='http://www.w3.org/2001/XInclude'>\n"
            f"{body}</root>")
        return str(outer)

    def test_included_lines_and_file(self, tmp_path):
        (tmp_path / "inner.xml").write_text("\n\n<inner val='x'/>")
        doc = Document(self._outer(tmp_path, "<xi:include href='inner.xml'/>"))
        inner = doc.root.child("inner")
        assert inner.line == 3
        assert inner.filename == str(tmp_path / "inner.xml")
        with pytest.raises(XmlValidityError) as err:
            inner.attribute("val", int)
        assert err.value.line == 3

    def test_nested_includes_resolve_relative(self, tmp_path):
        sub = tmp_path / "sub"
        sub.mkdir()
        (sub / "leaf.xml").write_text("<leaf/>")
        (sub / "mid.xml").write_text(
            "<mid xmlns:xi='http://www.w3.org/2001/XInclude'>"
            "<xi:include href='leaf.xml'/></mid>")
        doc = Document(self._outer(tmp_path,
                                   "<xi:include href='sub/mid.xml'/>"))
        assert doc.root.child("mid").child("leaf") is not None

    def test_text_include(self, tmp_path):
        (tmp_path / "v.txt").write_text("0.25")
        doc = Document(self._outer(
            tmp_path, "<v><xi:include href='v.txt' parse='text'/></v>"))
        assert doc.root.child("v").text(float) == 0.25

    def test_missing_target(self, tmp_path):
        with pytest.raises(XIncludeError):
            Document(self._outer(tmp_path, "<xi:include href='nope.xml'/>"))

    def test_include_loop(self, tmp_path):
        (tmp_path / "a.xml").write_text(
            "<a xmlns:xi='http://www.w3.org/2001/XInclude'>"
            "<xi:include href='a.xml'/></a>")
        with pytest.raises(XIncludeError):
            Document(self._outer(tmp_path, "<xi:include href='a.xml'/>"))

    @pytest.mark.parametrize("href", ["http://example.invalid/x.xml",
                                      "ftp://example.invalid/x.xml"])
    def test_network_refused(self, tmp_path, href):
        with pytest.raises(XIncludeError, match="non-local"):
            Document(self._outer(tmp_path, f"<xi:include href='{href}'/>"))

    def test_malformed_target(self, tmp_path):
        (tmp_path / "bad.xml").write_text("<bad>")
        with pytest.raises(XIncludeError):
            Document(self._outer(tmp_path, "<xi:include href='bad.xml'/>"))


class TestValidatorWithoutLxml:
    def test_missing_lxml_named(self, monkeypatch):
        import sys
        from canopy_tpu.errors import IllegalOperation
        from canopy_tpu.io.xml import Validator
        from canopy_tpu.schemas import default_schema_path
        monkeypatch.setitem(sys.modules, "lxml", None)
        with pytest.raises(IllegalOperation, match="lxml"):
            Validator(default_schema_path())

    def test_parsing_needs_no_lxml(self, monkeypatch):
        import sys
        monkeypatch.setitem(sys.modules, "lxml", None)
        doc = Document.from_string("<root><a/></root>")
        assert doc.root.child("a").name == "a"

    def test_cli_without_lxml(self, monkeypatch, capsys):
        import os
        import sys
        from canopy_tpu.cli import main
        monkeypatch.setitem(sys.modules, "lxml", None)
        fixture = os.path.join(os.path.dirname(__file__), "fixtures",
                               "station_blackout.xml")
        assert main([fixture, "--probability"]) == 0
        assert main([fixture, "--probability", "--validate"]) == 1
        assert "lxml" in capsys.readouterr().err


class TestWritersUseStdlib:
    def test_report_xml_declaration_and_indent(self):
        import xml.etree.ElementTree as ET
        from canopy_tpu.engine.analysis import Report
        from canopy_tpu.report import report_to_xml
        payload = report_to_xml(Report(model="m", settings={"a": 1},
                                       fault_trees=[], sequences=[],
                                       timings={"total": 0.5}))
        assert payload.startswith(b"<?xml")
        assert b"\n  <information>" in payload
        root = ET.fromstring(payload)
        assert root.find("information/model").get("name") == "m"
