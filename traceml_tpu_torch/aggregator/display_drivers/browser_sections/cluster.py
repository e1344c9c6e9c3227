"""Cluster section: the cross-node rollup table and the per-rank heatmap.

Counterpart of ``.../browser_sections/cluster.py`` (copied).  The heatmap
colors each rank's metric by its ratio to the cross-rank median; a zero
median with a nonzero outlier reads as hot, so the outlier still flags.
Both cards hide themselves on single-rank runs.
"""

from __future__ import annotations

from traceml_tpu_torch.aggregator.display_drivers.browser_sections import Section

_HTML = """
<div id="cluster-card" style="display:none">
<div class="chead"><h2 class="ctitle">Cluster</h2>
  <span class="cmeta" id="cluster-sub"></span><span class="sp"></span></div>
<div id="cluster"></div></div>
<div id="heatmap-card" style="display:none;margin-top:.8rem">
<div class="chead"><h2 class="ctitle">Per-rank heatmap</h2>
  <span class="cmeta">relative to cross-rank median</span><span class="sp"></span></div>
<div id="heatmap"></div></div>
"""

_JS = r"""
function heatColor(ratio){
  if(ratio==null||isNaN(ratio))return"rgba(233,236,245,0.05)";
  const x=Math.max(0,Math.min(1,(ratio-0.85)/1.15));
  return`hsl(${(220-220*x).toFixed(0)},62%,${(26+x*14).toFixed(0)}%)`}
function render_cluster(d){
  const card=document.getElementById("cluster-card");
  const s=d.system;
  if(s&&s.is_cluster&&(s.rollups||[]).length){
    card.style.display="";
    document.getElementById("cluster-sub").textContent=
      `${s.nodes.length}/${s.expected_nodes} nodes`+
      (s.missing_nodes?` · ${esc(s.missing_nodes)} MISSING`:"");
    let cr=`<table><tr><th>metric</th><th class="num">min</th>
      <th class="num">median</th><th class="num">max</th><th>max node</th></tr>`;
    for(const r of s.rollups){
      cr+=`<tr><td>${esc(r.metric)}</td><td class="num">${r.min_value.toFixed(1)}</td>
        <td class="num">${r.median_value.toFixed(1)}</td>
        <td class="num">${r.max_value.toFixed(1)}</td><td>${esc(r.max_node)}</td></tr>`}
    document.getElementById("cluster").innerHTML=cr+"</table>"
  }else card.style.display="none";
  // per-rank heatmap assembled from step/memory/process payloads
  const hcard=document.getElementById("heatmap-card");
  const el=document.getElementById("heatmap");
  const ranks={};
  const st=d.step_time;
  if(st&&st.step_series)for(const r in st.step_series){
    const sr=st.step_series[r];if(!sr.length)continue;
    const tail=sr.slice(-8);
    (ranks[r]=ranks[r]||{}).step_ms=tail.reduce((a,b)=>a+b,0)/tail.length}
  if(d.memory&&d.memory.ranks)for(const m of d.memory.ranks)
    (ranks[m.rank]=ranks[m.rank]||{}).mem_pressure=m.pressure;
  if(d.process&&d.process.ranks)for(const p of d.process.ranks){
    (ranks[p.rank]=ranks[p.rank]||{}).cpu_pct=p.cpu_pct;
    ranks[p.rank].rss=p.rss_bytes}
  const ids=Object.keys(ranks).sort((a,b)=>a-b);
  if(ids.length<2){hcard.style.display="none";return}
  hcard.style.display="";
  const METRICS=["step_ms","mem_pressure","cpu_pct","rss"];
  const med={};
  for(const m of METRICS){
    const vs=ids.map(r=>ranks[r][m]).filter(v=>v!=null).sort((a,b)=>a-b);
    med[m]=vs.length?vs[Math.floor(vs.length/2)]:null}
  let html=`<table class="heat"><tr><th class="num">rank</th>`+
    METRICS.map(m=>`<th>${esc(m)}</th>`).join("")+`</tr>`;
  for(const r of ids){
    html+=`<tr><td class="num">${esc(r)}</td>`;
    for(const m of METRICS){
      const v=ranks[r][m];
      const ratio=(v==null||med[m]==null)?null:
        med[m]>0?v/med[m]:(v>0?2:1);
      const label=v==null?"—":(m==="rss"?fmtB(v):m==="mem_pressure"?pct(v):
        m==="cpu_pct"?v.toFixed(0)+"%":fmtMs(v));
      html+=`<td style="background:${heatColor(ratio)}">${label}
        ${ratio!=null&&ratio>1.15?`<span class="muted">(${ratio.toFixed(2)}×)</span>`:""}</td>`}
    html+="</tr>"}
  el.innerHTML=html+"</table>"}
"""

SECTION = Section(
    id="cluster",
    title="Cluster",
    html=_HTML,
    js=_JS,
    contract=(
        "system.is_cluster",
        "system.rollups.metric",
        "system.rollups.min_value",
        "system.rollups.median_value",
        "system.rollups.max_value",
        "system.rollups.max_node",
        "system.expected_nodes",
        "system.missing_nodes",
        "step_time.step_series",
        "memory.ranks.pressure",
        "process.ranks.cpu_pct",
        "process.ranks.rss_bytes",
    ),
)
