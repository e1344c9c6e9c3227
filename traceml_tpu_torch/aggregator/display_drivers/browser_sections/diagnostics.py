"""Diagnostics rail: an overall severity pill and one row per finding.

Counterpart of ``.../browser_sections/diagnostics.py`` (copied).  Each
row's color comes from the finding's own severity field, so new
diagnosis kinds color correctly with no change here.
"""

from __future__ import annotations

from traceml_tpu_torch.aggregator.display_drivers.browser_sections import Section

_HTML = """
<div class="chead"><h2 class="ctitle">Diagnostics</h2><span class="sp"></span>
  <span id="diag-pill"></span></div>
<div id="findings"><span class="muted">no findings yet</span></div>
"""

_JS = r"""
const SEV_RANK={critical:2,warning:1,info:0};
function render_diagnostics(d){
  const el=document.getElementById("findings");
  const pill=document.getElementById("diag-pill");
  const fs=d.findings||[];
  if(!fs.length){
    el.innerHTML='<span class="muted">no findings yet</span>';
    pill.innerHTML="";return}
  const worst=fs.reduce((a,f)=>
    (SEV_RANK[f.severity]||0)>(SEV_RANK[a.severity]||0)?f:a,fs[0]);
  pill.innerHTML=`<span class="sevpill"
    style="background:${SEV[worst.severity]||"#555"}">${esc(worst.severity)}</span>`;
  el.innerHTML=fs.map(f=>`<div class="finding sev-${esc(f.severity)}">
    <b>${esc(f.domain)}/${esc(f.kind)}</b>
    <span class="muted">[${esc(f.severity)}]</span>
    ${f.confidence_label?`<span class="muted">· ${esc(f.confidence_label)} confidence</span>`:""}
    <br>${esc(f.summary)}
    ${f.action?`<br><span class="muted">→ ${esc(f.action)}</span>`:""}</div>`).join("")}
"""

SECTION = Section(
    id="diagnostics",
    title="Diagnostics",
    html=_HTML,
    js=_JS,
    contract=(
        "findings.severity",
        "findings.domain",
        "findings.kind",
        "findings.summary",
        "findings.action",
        "findings.confidence_label",
    ),
)
