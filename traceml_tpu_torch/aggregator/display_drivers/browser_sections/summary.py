"""The final-summary card and the rank-0 output card.

Counterpart of ``.../browser_sections/summary.py`` (copied).  The summary
card appears once ``/api/summary`` serves ``final_summary.json`` (polled
every 5th tick); the output card shows the rank-0 stdout lines of the
payload's ``stdout`` fragment.
"""

from __future__ import annotations

from traceml_tpu_torch.aggregator.display_drivers.browser_sections import Section

_HTML = """
<div class="card reveal" id="summary" style="display:none"></div>
"""

_JS = r"""
let summaryLoaded=false,summaryTick=0;
async function render_summary(d){
  if(summaryLoaded||(summaryTick++%5))return;
  try{
    const r=await fetch("/api/summary");if(!r.ok)return;
    const s=await r.json();if(!s||!s.sections)return;
    summaryLoaded=true;drawSummary(s)
  }catch(e){}}
function drawSummary(s){
  const el=document.getElementById("summary");
  const p=s.primary_diagnosis||{};
  const secs=s.sections||{};
  const chips=Object.keys(secs).map(k=>
    `<span class="badge">${esc(k)}: ${esc((secs[k]||{}).status||"—")}</span>`).join(" ");
  const topo=(s.meta||{}).topology||{};
  const eff=((secs.step_time||{}).global||{}).efficiency;
  el.style.display="";
  el.innerHTML=`<div class="chead"><h2 class="ctitle">Final summary</h2>
    <span class="badge">run finished</span></div>
    <div class="finding sev-${esc(p.severity||"info")}">
      <b>${esc(p.kind||"NO_DATA")}</b>
      <span class="muted">[${esc(p.severity||"")}]</span><br>${esc(p.summary||"")}
      ${p.action?`<br><span class="muted">→ ${esc(p.action)}</span>`:""}</div>
    <div style="margin:.4rem 0">${chips}</div>
    <div class="muted">world ${esc(topo.world_size!=null?topo.world_size:"?")}
      · mode ${esc(topo.mode||"?")}
      ${eff&&eff.achieved_tflops_median!=null?` · ${Number(eff.achieved_tflops_median).toFixed(1)} TFLOP/s`+
        (eff.mfu_median!=null?` · MFU ${(eff.mfu_median*100).toFixed(0)}%`:""):""}</div>`}
"""

SECTION = Section(
    id="summary",
    title="Final summary",
    html=_HTML,
    js=_JS,
    contract=(),  # reads /api/summary (final_summary.json), not /api/live
)

OUTPUT_SECTION = Section(
    id="output",
    title="Rank 0 output",
    html="""
<div class="chead"><h2 class="ctitle">Rank 0 output</h2><span class="sp"></span></div>
<pre id="stdout"></pre>
""",
    js=r"""
function render_output(d){
  document.getElementById("stdout").textContent=
    (d.stdout||[]).map(l=>l.line).join("\n")}
""",
    contract=("stdout.line",),
)
