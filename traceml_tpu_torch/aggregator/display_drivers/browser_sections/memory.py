"""Device-memory section: the per-rank pressure table with history
sparklines and a KPI strip (worst pressure, total current, max growth).

Counterpart of ``.../browser_sections/memory.py`` (copied).  Pressure and
growth come from the renderer views; the KPIs are presentation math over
the same payload.
"""

from __future__ import annotations

from traceml_tpu_torch.aggregator.display_drivers.browser_sections import Section

_HTML = """
<div class="chead"><h2 class="ctitle">Device memory</h2><span class="sp"></span>
  <span id="mem-badge"></span></div>
<div class="kpis" id="mem-kpis" style="margin:.1rem 0 .6rem"></div>
<div id="memory"></div>
"""

_JS = r"""
let memBuilt=false;
function buildMem(){
  document.getElementById("mem-kpis").innerHTML=
    kpiTile("mem-worst","WORST PRESSURE","var(--crit)")+
    kpiTile("mem-total","TOTAL CURRENT","var(--accent)")+
    kpiTile("mem-growth","MAX GROWTH","#f1c40f");
  memBuilt=true}
function render_memory(d){
  if(!memBuilt)buildMem();
  const m=d.memory;badge("mem-badge",d.ts,m&&m.latest_ts);
  const el=document.getElementById("memory");
  if(!m||!m.ranks||!m.ranks.length){
    el.innerHTML='<span class="muted">no memory telemetry</span>';return}
  const pressures=m.ranks.map(s=>s.pressure).filter(v=>v!=null);
  setKpi("mem-worst",pressures.length?
    (Math.max(...pressures)*100).toFixed(0):null,"%");
  setKpi("mem-total",fmtB(m.total_current_bytes).split(" ")[0],
    fmtB(m.total_current_bytes).split(" ")[1]);
  const growths=m.ranks.map(s=>s.growth_bytes).filter(v=>v!=null);
  const gmax=growths.length?Math.max(...growths):null;
  setKpi("mem-growth",gmax==null?null:
    (gmax>=0?"+":"−")+fmtB(Math.abs(gmax)).split(" ")[0],
    gmax==null?"":fmtB(Math.abs(gmax)).split(" ")[1]);
  let rows=`<table><tr><th class="num">rank</th><th>device</th>
    <th class="num">current</th><th class="num">step peak</th>
    <th class="num">limit</th><th>pressure</th><th class="num">growth</th><th>history</th></tr>`;
  for(const s of m.ranks){
    const hist=s.history||[];const hmax=Math.max(1,...hist);
    const spark=hist.length>1?`<svg width="100" height="18" viewBox="0 0 100 18">
      <polyline fill="none" stroke="var(--accent-deep)" stroke-width="1"
        points="${sparkPath(hist,100,18,hmax)}"/></svg>`:"—";
    const g=s.growth_bytes;
    const worst=s.rank===m.worst_pressure_rank?' style="color:#ffd27f"':"";
    rows+=`<tr><td class="num"${worst}>${esc(s.rank)}</td><td>${esc(s.device_kind)}</td>
      <td class="num">${fmtB(s.current_bytes)}</td>
      <td class="num">${fmtB(s.step_peak_bytes)}</td>
      <td class="num">${fmtB(s.limit_bytes)}</td>
      <td>${meter(s.pressure,0.92,0.97)}</td>
      <td class="num">${g?(g>0?"+":"-")+fmtB(Math.abs(g)):"—"}</td>
      <td>${spark}</td></tr>`}
  el.innerHTML=rows+"</table>"}
"""

SECTION = Section(
    id="memory",
    title="Device memory",
    html=_HTML,
    js=_JS,
    contract=(
        "ts",
        "memory.latest_ts",
        "memory.ranks.rank",
        "memory.ranks.device_kind",
        "memory.ranks.current_bytes",
        "memory.ranks.step_peak_bytes",
        "memory.ranks.limit_bytes",
        "memory.ranks.pressure",
        "memory.ranks.growth_bytes",
        "memory.ranks.history",
        "memory.worst_pressure_rank",
        "memory.total_current_bytes",
    ),
)
