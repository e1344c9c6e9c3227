"""Step-time detail section: the stacked per-step phase chart with a
crosshair tooltip, the phase table, and the per-rank sparkline whose
rank chips toggle ranks.

Counterpart of ``.../browser_sections/step_time.py``; its one label
change: the occupancy reads "GPU busy" (JAX: "chip busy").  The
full-run history strip (the payload's ``history``, the stitched rollup
tiers' cross-rank band) shows once the writer's first prune has folded
rows, and stays hidden before, as in JAX.
"""

from __future__ import annotations

from traceml_tpu_torch.aggregator.display_drivers.browser_sections import Section

_HTML = """
<div class="chead"><h2 class="ctitle">Phases</h2><span class="sp"></span>
  <span class="cmeta" id="st-occ"></span><span id="st-badge"></span></div>
<div class="legend" id="st-legend"></div>
<svg id="st-stack" class="chart" viewBox="0 0 600 120" preserveAspectRatio="none"></svg>
<div id="st-table"></div>
<div class="legend" id="st-ranks" style="margin-top:.5rem"></div>
<svg id="st-spark" class="spark" viewBox="0 0 600 64" preserveAspectRatio="none"></svg>
<div class="muted">per-rank step time (window tail) — click a rank chip to toggle</div>
<div id="st-history-wrap" style="display:none">
  <svg id="st-history" class="spark" viewBox="0 0 600 48" preserveAspectRatio="none"></svg>
  <div class="muted" id="st-history-meta">full-run history (stitched rollup tiers)</div>
</div>
"""

_JS = r"""
const rankHidden=new Set();
let stLast=null,stLastTs=null,stHistLast=null;
function render_step_time(d){
  const st=d.step_time;badge("st-badge",d.ts,st&&st.latest_ts);
  if(d.history)stHistLast=d.history;
  renderStHistory((d.history||stHistLast||{}).step_time);
  if(!st)return;
  stLast=st;stLastTs=d.ts;
  document.getElementById("st-occ").textContent=
    (st.median_occupancy!=null?`GPU busy ${(st.median_occupancy*100).toFixed(0)}%`:"")+
    (st.efficiency&&st.efficiency.achieved_tflops_median!=null?
      ` · ${st.efficiency.achieved_tflops_median.toFixed(1)} TFLOP/s`:"")+
    (st.efficiency&&st.efficiency.tokens_per_sec_median!=null?
      ` · ${Math.round(st.efficiency.tokens_per_sec_median).toLocaleString()} tok/s`:"");
  // stacked per-step phase chart (cross-rank medians)
  const stack=st.phase_stack||{};const keys=Object.keys(stack);
  const n=keys.length?stack[keys[0]].length:0;
  let maxTot=1;const totals=[];
  for(let i=0;i<n;i++){let t=0;for(const k of keys)t+=stack[k][i]||0;
    totals.push(t);maxTot=Math.max(maxTot,t)}
  let bars="";const bw=600/Math.max(1,n);
  for(let i=0;i<n;i++){let y=118;
    for(const k of keys){const h=(stack[k][i]||0)/maxTot*112;y-=h;
      bars+=`<rect x="${(i*bw).toFixed(1)}" y="${y.toFixed(1)}"
        width="${Math.max(0.5,bw-0.6).toFixed(1)}" height="${h.toFixed(1)}"
        fill="${COLORS[k]||"#888"}"></rect>`}}
  document.getElementById("st-stack").innerHTML=bars;
  document.getElementById("st-legend").innerHTML=keys.map(k=>
    `<span><i style="background:${COLORS[k]||"#888"}"></i>${esc(k)}</span>`).join("");
  hookTip("st-stack",frac=>{
    if(!stLast)return null;
    const stk=stLast.phase_stack||{};const ks=Object.keys(stk);
    const m=ks.length?stk[ks[0]].length:0;if(!m)return null;
    const i=Math.min(m-1,Math.floor(frac*m));
    const stepId=(stLast.steps||[])[i];
    let h=`<b>step ${esc(stepId!=null?stepId:i)}</b>`;
    for(const k of ks)if(stk[k][i])h+=`<br><i style="display:inline-block;width:8px;height:8px;border-radius:2px;background:${COLORS[k]||"#888"};margin-right:4px"></i>${esc(k)} ${fmtMs(stk[k][i])}`;
    return h});
  // phase table — both ends of the spread name a rank (median-closest
  // / worst), same pairing as the CLI and report
  let rows=`<table><tr><th>phase</th><th class="num">median</th>
    <th class="num">share</th><th class="num">rank m/w</th>
    <th class="num">skew</th></tr>`;
  for(const p of st.phases||[]){
    const rankPair=p.median_rank!=null
      ?`r${esc(p.median_rank)}/r${esc(p.worst_rank)}`:esc(p.worst_rank);
    rows+=`<tr><td>${esc(p.key)}</td><td class="num">${fmtMs(p.median_ms)}</td>
      <td class="num">${pct(p.share)}</td><td class="num">${rankPair}</td>
      <td class="num">${pct(p.skew_pct)}</td></tr>`}
  document.getElementById("st-table").innerHTML=rows+"</table>";
  // per-rank sparkline with rank toggle
  const series=st.step_series||{};const ranks=Object.keys(series);
  document.getElementById("st-ranks").innerHTML=ranks.map((r,ri)=>
    `<span class="toggle${rankHidden.has(r)?" off":""}" data-rank="${esc(r)}"
       onclick="stToggleRank(this.dataset.rank)">
       <i style="background:${rankColor(ri)}"></i>r${esc(r)}</span>`).join("");
  let max=1;
  for(const r of ranks){if(rankHidden.has(r))continue;
    for(const v of series[r])max=Math.max(max,v)}
  let paths="";
  ranks.forEach((r,ri)=>{const s=series[r];
    if(!s.length||rankHidden.has(r))return;
    paths+=`<polyline fill="none" stroke="${rankColor(ri)}"
      stroke-width="1.5" points="${sparkPath(s,600,64,max)}"/>`});
  document.getElementById("st-spark").innerHTML=paths;
  hookTip("st-spark",frac=>{
    if(!stLast)return null;
    const ser=stLast.step_series||{};const rs=Object.keys(ser);
    if(!rs.length)return null;
    let h="";
    for(const r of rs){if(rankHidden.has(r))continue;
      const s=ser[r];if(!s.length)continue;
      const i=Math.min(s.length-1,Math.floor(frac*s.length));
      h+=`${h?"<br>":""}r${esc(r)}: ${fmtMs(s[i])}`}
    return h||null});
}
function stToggleRank(r){
  if(rankHidden.has(r))rankHidden.delete(r);else rankHidden.add(r);
  // repaint with the SERVER timestamp of the cached payload — a client
  // clock here would cross clocks in the staleness badge
  if(stLast)render_step_time({step_time:stLast,ts:stLastTs})}
// full-run history strip: stitched rollup tiers (raw/10s/1m) as a
// min–max band + cross-rank mean line over the WHOLE run, not just the
// live window tail.  Hidden until the first fold lands in the payload.
function renderStHistory(hist){
  const wrap=document.getElementById("st-history-wrap");
  const pts=hist&&hist.points;
  if(!pts||pts.length<2){wrap.style.display="none";return}
  wrap.style.display="";
  const t0=pts[0].t,t1=pts[pts.length-1].t,span=Math.max(1e-9,t1-t0);
  let hmax=1;for(const p of pts)hmax=Math.max(hmax,p.max_ms||0);
  const X=p=>(p.t-t0)/span*600;
  const Y=v=>46-(v/hmax*44);
  let band="";for(const p of pts)band+=`${X(p).toFixed(1)},${Y(p.max_ms).toFixed(1)} `;
  for(let i=pts.length-1;i>=0;i--)band+=`${X(pts[i]).toFixed(1)},${Y(pts[i].min_ms).toFixed(1)} `;
  let mean="";for(const p of pts)mean+=`${X(p).toFixed(1)},${Y(p.mean_ms).toFixed(1)} `;
  document.getElementById("st-history").innerHTML=
    `<polygon points="${band}" fill="rgba(110,145,220,.22)" stroke="none"></polygon>`+
    `<polyline fill="none" stroke="#6e91dc" stroke-width="1.2" points="${mean}"></polyline>`;
  const res=[...new Set(pts.map(p=>p.res))].join("/");
  document.getElementById("st-history-meta").textContent=
    `full-run history: ${pts.length} buckets · ${(span/3600).toFixed(1)} h · `+
    `${Math.round(hist.ranks||0)} rank(s) · ${esc(res)} resolution (stitched rollup tiers)`;
  hookTip("st-history",frac=>{
    const i=Math.min(pts.length-1,Math.floor(frac*pts.length));
    const p=pts[i];
    return `<b>+${((p.t-t0)/60).toFixed(1)} min</b> (${esc(p.res)})`+
      `<br>mean ${fmtMs(p.mean_ms)}<br>min ${fmtMs(p.min_ms)} · max ${fmtMs(p.max_ms)}`});
}
"""

SECTION = Section(
    id="step_time",
    title="Phases",
    html=_HTML,
    js=_JS,
    contract=(
        "ts",
        "step_time.latest_ts",
        "step_time.median_occupancy",
        "step_time.efficiency.achieved_tflops_median",
        "step_time.efficiency.tokens_per_sec_median",
        "step_time.phase_stack",
        "step_time.steps",
        "step_time.phases.key",
        "step_time.phases.median_ms",
        "step_time.phases.share",
        "step_time.phases.worst_rank",
        "step_time.phases.median_rank",
        "step_time.phases.skew_pct",
        "step_time.step_series",
        "history.step_time.points.t",
        "history.step_time.points.mean_ms",
        "history.step_time.points.min_ms",
        "history.step_time.points.max_ms",
        "history.step_time.points.res",
        "history.step_time.ranks",
    ),
)
